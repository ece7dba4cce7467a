"""chip_smoke: the minh/minp encode -> write -> read path on the GPU, at
real size, checked byte for byte against the host path.

Usage:
  python chip_smoke.py [--seed N] [--workdir DIR]
  python chip_smoke.py --cards 4 [--seed N]

One process drives the card from start to finish; the data is generated
from ``--seed``.  With no GPU it says why and exits 2 before any phase.
Phases, in order (each prints one line: name, sizes, wall seconds with
compile split from run, and its comparisons):

  card        nvidia-smi name and power limit (a child that never imports
              JAX), jax version, device_kind, XLA_FLAGS
  exact       ops/validate.validate_backend() on the card, and the
              quantizer/dequantizer routes it gated
  minh        a 2,000,000-row Rockstar-style catalog through
              ``text_to_minh ... --device``, byte-identical to the host
              conversion
  minh_read   every compressed column through minh_device, dither
              ``none`` and ``uniform``, bitwise equal to the host reader
  boundary    ``minh_to_bnd 8 5.0 ... --device`` byte-identical to host
  minp        a 256^3-particle LGadget-2 snapshot (8 files) through
              ``convert_snapshot to_minp ... 4 8 0.001 1.0 --device``,
              byte-identical to host; x and v read back through
              minp_device in both dither modes, bitwise equal to host
  flagship    device time of the XLA encode and decode at 18-bit
              positions in 2^17-element blocks (>= 1 GB of f32) and of
              a 41-bit int64 ID column; GB/s and share of 3.35 TB/s
              (a finding, not a claim)

``--cards 4`` runs only the block-sharded encode over a 1-D mesh of four
cards (the snapshot's sub-cell blocks and the catalog's float and int
columns), checks the inputs sit on four distinct devices and the bytes
equal the host spec encoding, and prints per-device peak memory.

Any failed comparison ends the script with exit 1 and no result line.
The last line of a passing run is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

CATALOG_ROWS = 2_000_000
SNAP_SIDE = 256          # 256^3 particles
SNAP_FILES = 8
BOX = 250.0              # Mpc/h
H100_HBM_GBPS = 3350.0   # NVIDIA H100 SXM5 data sheet: 3.35 TB/s


# -- timing ----------------------------------------------------------------


class CompileClock:
    """Seconds JAX spends lowering and compiling, summed from its own
    monitoring events (so a phase's wall time splits into compile and
    run).  Tracing is left out: nested traces report overlapping
    durations."""

    _EVENTS = ("/jax/core/compile/backend_compile_duration",
               "/jax/core/compile/jaxpr_to_mlir_module_duration")

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, secs, **_):
        if event in self._EVENTS:
            self.total += secs


@contextlib.contextmanager
def phase(name, clock, sizes=""):
    """Run one phase and print its line; re-raise a failed comparison
    after printing it."""
    c0, t0 = (clock.total if clock else 0.0), time.perf_counter()
    info = {}
    try:
        yield info
    except Exception as e:
        import traceback

        traceback.print_exc()
        print("phase %-10s FAIL %s: %s" % (name, type(e).__name__, e),
              flush=True)
        raise
    wall = time.perf_counter() - t0
    comp = (clock.total - c0) if clock else 0.0
    extra = " ".join("%s=%s" % kv for kv in info.items())
    print("phase %-10s %s wall %.2f s (compile %.2f s, run %.2f s) %s"
          % (name, sizes, wall, comp, wall - comp, extra), flush=True)


def _same_tree(a, b):
    """Byte-compare every file of two output directories; returns the
    number of files and bytes compared."""
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    if fa != fb:
        raise AssertionError("file sets differ: %s vs %s" % (fa, fb))
    nbytes = 0
    for f in fa:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            da, db = x.read(), y.read()
        if da != db:
            raise AssertionError("%s differs between device and host "
                                 "runs" % f)
        nbytes += len(da)
    return len(fa), nbytes


def _host_vs_device(work, prefix, cli_main, argv):
    """Run a CLI's ``main(argv(out_dir))`` without and with ``--device``
    into ``<work>/<prefix>_host`` and ``<prefix>_device`` and
    byte-compare the two outputs.  Returns timings and what was
    compared."""
    out = {}
    for mode in ("host", "device"):
        d = os.path.join(work, "%s_%s" % (prefix, mode))
        os.makedirs(d, exist_ok=True)
        t0 = time.perf_counter()
        cli_main(argv(d) + (["--device"] if mode == "device" else []))
        out[mode + "_s"] = round(time.perf_counter() - t0, 2)
    files, nbytes = _same_tree(os.path.join(work, prefix + "_host"),
                               os.path.join(work, prefix + "_device"))
    out.update(files=files, bytes=nbytes, identical=True)
    return out


def _bitwise(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype or \
            a.tobytes() != b.tobytes():
        raise AssertionError("%s: device and host reads differ" % what)


# -- phase 0: card ---------------------------------------------------------


def card_info():
    """nvidia-smi name and power limit (from a child that never imports
    JAX), jax version, device_kind and the XLA_FLAGS in force."""
    import jax

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        smi = " | ".join(smi.splitlines())  # one line per card
    except FileNotFoundError:
        smi = "nvidia-smi not found"
    dev = jax.devices()[0]
    return {"nvidia_smi": smi, "jax": jax.__version__,
            "device_kind": dev.device_kind,
            "XLA_FLAGS": os.environ.get("XLA_FLAGS", "")}


# -- phase 1: exactness ----------------------------------------------------


def exact():
    from minnow_tpu.ops import validate

    report = validate.validate_backend()
    if not report["exact"]:
        raise AssertionError("backend is not bit-exact")
    return report


# -- phases 2-4: minh ------------------------------------------------------


def write_catalog(dirpath, rows, seed):
    """A Rockstar-style text catalog: 41-bit int64 IDs, positions in a
    250 Mpc/h box, velocities within +-5000 km/s, log masses.  Returns
    (config path, catalog path)."""
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1 << 41, rows, dtype=np.int64)
    pos = rng.uniform(0, BOX, (rows, 3))
    vel = np.clip(rng.normal(0, 400, (rows, 3)), -4999, 4999)
    mvir = 10.0 ** rng.uniform(10, 15, rows)
    hlist = os.path.join(dirpath, "hlist_1.00000.list")
    with open(hlist, "w") as f:
        f.write("#ID X Y Z VX VY VZ Mvir\n")
        np.savetxt(f, np.column_stack([ids, pos, vel, mvir]),
                   fmt="%d %.5f %.5f %.5f %.3f %.3f %.3f %.6e")
    names = os.path.join(dirpath, "names.txt")
    with open(names, "w") as f:
        f.write("id ID\nx X\ny Y\nz Z\nvx VX\nvy VY\nvz VZ\nmvir Mvir\n")
    types = os.path.join(dirpath, "types.txt")
    with open(types, "w") as f:
        f.write("id int\n"
                + "".join("%s q_float position\n" % c for c in "xyz")
                + "".join("v%s q_float linear -5000 5000 1\n" % c
                          for c in "xyz")
                + "mvir q_float log 1e5 1e16 0.001\n")
    cfg = os.path.join(dirpath, "run.config")
    with open(cfg, "w") as f:
        f.write("[minh]\nL = %g\nEpsilon = 0.001\nMp = 1e8\n"
                "MinParticles = 10\nMassName = mvir\nNameIndex = %s\n"
                "TypeIndex = %s\n" % (BOX, names, types))
    return cfg, hlist


def minh_convert(work, rows, seed):
    """Catalog -> .minh through ``text_to_minh --device`` and through the
    host path; the two files must be byte-identical."""
    from minnow_tpu.cli import text_to_minh

    cfg, hlist = write_catalog(os.path.join(work, "catalog"), rows, seed)
    out = _host_vs_device(work, "minh", text_to_minh.main,
                          lambda d: [cfg, "all", hlist, d])
    return text_to_minh.out_name(os.path.join(work, "minh_device"),
                                 hlist), out


def minh_read(path):
    """Every compressed column through the device readers, in dither
    modes none and uniform, bitwise against the host reader."""
    from minnow_tpu.formats import minh, minh_device

    checked = 0
    for mode in ("none", "uniform"):
        r = minh.open(path, dither=mode)
        try:
            floats = [n for n, c in zip(r.names, r.columns)
                      if c.type == minh.Float]
            ints = [n for n, c in zip(r.names, r.columns)
                    if c.type == minh.Int]
            host = {**r.floats(floats), **r.ints(ints)}
            dev = {**minh_device.read_floats(r, floats),
                   **minh_device.read_ints(r, ints)}
            for name in floats + ints:
                _bitwise(dev[name], host[name], "%s (%s)" % (name, mode))
                checked += 1
        finally:
            r.close()
    return {"columns_x_modes": checked, "bitwise_equal": True}


def boundary(work, minh_path, cells=8, bnd=5.0):
    """``minh_to_bnd`` with and without --device: byte-identical."""
    from minnow_tpu.cli import minh_to_bnd

    return _host_vs_device(work, "bnd", minh_to_bnd.main, lambda d: [
        str(cells), str(bnd), minh_path, d])


# -- phase 5: minp ---------------------------------------------------------


def snapshot_arrays(n_side, seed, box=BOX):
    """Particles of a perturbed Lagrangian grid (Gaussian displacements,
    periodic wrap) and Gaussian velocities, with 1-based IDs in
    Lagrangian order.  Returns (x, v, ids)."""
    rng = np.random.default_rng(seed)
    n = n_side ** 3
    ids = np.arange(1, n + 1, dtype=np.int64)
    i = ids - 1
    grid = np.stack([i % n_side, (i // n_side) % n_side,
                     i // (n_side * n_side)], axis=1)
    cell = box / n_side
    x = (grid + 0.5) * cell + rng.normal(0, 2.0 * cell, (n, 3))
    x = np.mod(x, box).astype(np.float32)
    x[x >= np.float32(box)] = 0  # f32 rounding can land exactly on L
    v = rng.normal(0, 300.0, (n, 3)).astype(np.float32)
    return x, v, ids


def write_snapshot(dirpath, n_side, files, seed):
    """An LGadget-2 snapshot of ``n_side^3`` particles in ``files``
    files through ingest/lgadget2.write_lgadget2."""
    from minnow_tpu.formats import minp as minp_fmt
    from minnow_tpu.ingest import lgadget2, snapshot

    os.makedirs(dirpath, exist_ok=True)
    x, v, ids = snapshot_arrays(n_side, seed)
    # scramble the particle order across files, as a simulation's
    # domain decomposition does
    perm = np.random.default_rng(seed + 1).permutation(len(ids))
    parts = np.array_split(perm, files)
    z = 0.5
    hd = minp_fmt.Header(z=z, scale=1 / (1 + z), l=BOX, n_side=n_side,
                         n_total=n_side ** 3)
    snap = snapshot.MockSnapshot(hd, [x[p] for p in parts],
                                 [v[p] for p in parts],
                                 [ids[p] for p in parts])
    gh = lgadget2.LGadget2Header(
        time=1 / (1 + z), redshift=z, box_size=BOX, omega0=0.3,
        omega_lambda=0.7, hubble_param=0.7,
        n_part_total=(0, n_side ** 3, 0, 0, 0, 0), num_files=files)
    lgadget2.write_lgadget2(dirpath, "snap_%03d.dat", snap, gh)
    return x.nbytes + v.nbytes


def minp_convert(work, n_side, files, seed, file_cells=4, sub_cells=8):
    """Snapshot -> minp fileset through ``convert_snapshot --device``
    and the host path (byte-identical), then x and v read back through
    minp_device in both dither modes, bitwise against host."""
    from minnow_tpu.cli import convert_snapshot
    from minnow_tpu.formats import minp, minp_device

    snap_dir = os.path.join(work, "lgadget2")
    raw = write_snapshot(snap_dir, n_side, files, seed)
    out = {"f32_MB": round(raw / 1e6, 1)}
    out.update(_host_vs_device(work, "minp", convert_snapshot.main, lambda d: [
        "to_minp", snap_dir, d, str(file_cells), str(sub_cells), "0.001",
        "1.0"]))
    d = os.path.join(work, "minp_device")
    reads = 0
    for f in sorted(os.listdir(d)):
        for mode in ("none", "uniform"):
            r = minp.open(os.path.join(d, f), dither=mode)
            try:
                _bitwise(minp_device.read_vectors(r), r.vectors(),
                         "%s (%s)" % (f, mode))
            finally:
                r.close()
            reads += 1
    out.update(reads=reads, bitwise_equal=True)
    return out


# -- phase 6: flagship timing ----------------------------------------------


def _median_time(fn, args, reps):
    """Median wall seconds of ``fn(*args)`` to ``block_until_ready``
    after one warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _rate(name, secs, f32_bytes, moved_bytes):
    """One timing result: GB/s of the raw column, and the share of the
    card's 3.35 TB/s computed from the bytes read and written."""
    return {"op": name, "ms": round(secs * 1e3, 3),
            "GBps": round(f32_bytes / secs / 1e9, 1),
            "hbm_share": round(moved_bytes / secs / 1e9 / H100_HBM_GBPS,
                               4)}


def flagship(n_blocks=2048, n=1 << 17, id_blocks=512, id_n=1 << 18,
             reps=5, seed=0):
    """Device time of BlockEncoder's float encode work (the stats/prep
    dispatch and the width-specialized pack), the bulk decode in modes
    none and uniform, and the 41-bit int64 ID encode/decode, on
    device-resident inputs.  Byte model per element: encode reads 4 B
    and writes bits/8; decode the reverse (8 B for int64)."""
    import jax
    import jax.numpy as jnp

    from minnow_tpu.core import spec
    from minnow_tpu.ops import bitpack, codec, fastdiv

    bits, low, high, dx = 18, 0.0, BOX, 0.001
    pixels = spec.float_group_pixels(low, high, dx)
    key = jax.random.PRNGKey(seed)
    x = jax.block_until_ready(jax.random.uniform(
        key, (n_blocks, n), jnp.float32, 0.0, 249.9))
    b = n_blocks
    dxq = np.full(b, spec.quantize_dx(low, high, pixels), np.float32)
    db, deb, dm0, dm1, ok = fastdiv.divisor_magic(dxq)
    assert ok.all()
    lowv, highv = np.full(b, low, np.float32), np.full(b, high, np.float32)
    pixv, lens = np.full(b, pixels, np.int64), np.full(b, n, np.int64)
    per = np.ones(b, bool)
    consts = tuple(jax.device_put(a) for a in
                   (lowv, pixv, lens, per, db, deb, dm0, dm1))
    prep = codec.prepare_float_blocks_fast32
    deltas, mins, maxd, valid = prep(x, *consts)
    if not bool(np.asarray(valid).all()) or int(
            spec.precision_needed(int(np.asarray(maxd).max()))) != bits:
        raise AssertionError("flagship prep did not certify 18-bit blocks")
    words = jax.block_until_ready(bitpack.pack_batch(deltas, bits))
    elems = b * n
    f32 = elems * 4
    packed = elems * bits / 8
    ids = np.arange(b, dtype=np.int64)
    res = [
        _rate("encode_prep", _median_time(prep, (x,) + consts, reps),
              f32, f32 + elems * 4),
        _rate("encode_pack", _median_time(
            lambda d: bitpack.pack_batch(d, bits), (deltas,), reps),
            f32, elems * 4 + packed),
    ]
    res.append(_rate("encode_total", (res[0]["ms"] + res[1]["ms"]) / 1e3,
                     f32, f32 + packed))
    for mode in ("none", "uniform"):
        fn = jax.jit(lambda w, m, mode=mode: codec.decode_float_blocks32(
            w, m, lowv, highv, pixv, per, ids, bits, n, dither=mode))
        out = fn(words, mins)
        if mode == "none":
            err = float(jnp.max(jnp.minimum(jnp.abs(out - x),
                                            high - jnp.abs(out - x))))
            if err > 2 * dx * (1 + 1e-4):
                raise AssertionError("flagship roundtrip error %g" % err)
        del out
        res.append(_rate("decode_" + mode, _median_time(
            fn, (words, mins), reps), f32, packed + f32))
    del x, deltas, words

    # 41-bit int64 ID column: stats + fused delta+pack, and decode
    idv = jax.block_until_ready(jax.random.randint(
        key, (id_blocks, id_n), 0, 1 << 41, jnp.int64))
    ilens = jax.device_put(np.full(id_blocks, id_n, np.int64))
    imins, imaxd = codec.int_block_stats(idv, ilens)
    ibits = spec.precision_needed(int(np.asarray(imaxd).max()))
    iwords = jax.block_until_ready(
        bitpack.delta_pack_batch(idv, imins, ilens, ibits))
    if not bool(jnp.all(codec.decode_int_blocks(iwords, imins, ibits,
                                                id_n) == idv)):
        raise AssertionError("41-bit ID roundtrip failed")
    ielems = id_blocks * id_n
    i64, ipacked = ielems * 8, ielems * ibits / 8
    res.append(_rate("id_encode_stats", _median_time(
        codec.int_block_stats, (idv, ilens), reps), i64, i64))
    res.append(_rate("id_encode_pack", _median_time(
        lambda v, m, l: bitpack.delta_pack_batch(v, m, l, ibits),
        (idv, imins, ilens), reps), i64, i64 + ipacked))
    res.append(_rate("id_decode", _median_time(
        lambda w, m: codec.decode_int_blocks(w, m, ibits, id_n),
        (iwords, imins), reps), i64, ipacked + i64))
    stats = jax.devices()[0].memory_stats() or {}
    return {"shape": "%dx%d f32 (%.2f GB), ids %dx%d at %d bits"
                     % (b, n, f32 / 1e9, id_blocks, id_n, ibits),
            "results": res,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use")}


# -- four cards ------------------------------------------------------------


def sharded_encode(devices, n_side, rows, seed, work, n=1 << 17):
    """Block-sharded encode over a 1-D mesh of ``devices``: the
    snapshot's sub-cell blocks (through the minp writer, 4^3 file-cells
    of 8^3 sub-cells) and the catalog's float and int columns in
    ``n``-row blocks, bytes against the host spec encoding; inputs must
    sit on every device."""
    from minnow_tpu.core import spec
    from minnow_tpu.formats import minp
    from minnow_tpu.ingest import snapshot
    from minnow_tpu.parallel import BlockEncoder, mesh as mesh_lib

    mesh = mesh_lib.block_mesh(devices)
    enc = BlockEncoder(mesh=mesh)
    out = {"devices": len(devices)}

    # snapshot: every file-cell's sub-cell blocks through the minp
    # writer, device-encoded vs host-encoded, byte for byte
    x, v, ids = snapshot_arrays(n_side, seed)
    hd = minp.Header(l=BOX, n_side=n_side, n_total=n_side ** 3)
    grid = snapshot.Grid(snapshot.MockSnapshot(hd, [x], [v], [ids]), 4)
    nbytes = 0
    os.makedirs(work, exist_ok=True)
    for kind, read, step, periodic in (("x", grid.read_x, 0.001, True),
                                       ("v", grid.read_v, 1.0, False)):
        for i in range(grid.files()):
            data = []
            for e in (None, enc):
                fname = os.path.join(work, "%s_%d_%s.minp"
                                     % (kind, i, e is None))
                w = minp.create(fname, encoder=e)
                w.header(hd, b"", minp.Cell(i, 4, 8), step, periodic)
                w.vectors(read(i))
                w.close()
                with open(fname, "rb") as f:
                    data.append(f.read())
                os.remove(fname)
            if data[0] != data[1]:
                raise AssertionError("sharded minp %s_%d differs from "
                                     "host" % (kind, i))
            nbytes += len(data[0])
    out["minp_files"] = 2 * grid.files()
    out["minp_bytes"] = nbytes

    # catalog columns in n-row blocks
    rng = np.random.default_rng(seed)
    b = rows // n
    pos = rng.uniform(0, BOX, (b, n)).astype(np.float32)
    pixels = spec.float_group_pixels(0.0, BOX, 0.001)
    # placed as the encoder places a batch: padded to the mesh, sharded
    (placed,) = enc._shard(np.pad(pos, [(0, enc._pad(b) - b), (0, 0)]))
    on = {s.device for s in placed.addressable_shards}
    if len(on) != len(devices):
        raise AssertionError("inputs sit on %d devices, want %d"
                             % (len(on), len(devices)))
    out["shard_devices"] = len(on)
    fe = enc.encode_float_blocks(pos, 0.0, BOX, pixels)
    idv = rng.integers(0, 1 << 41, (b, n), dtype=np.int64)
    ie = enc.encode_int_blocks(idv)
    for i in range(b):
        payload, mn, bts, _ = spec.encode_float_block(pos[i], 0.0, BOX,
                                                      pixels)
        if (fe.payloads[i], int(fe.mins[i]), int(fe.bits[i])) != \
                (payload, mn, bts):
            raise AssertionError("sharded float block %d differs" % i)
        payload, mn, bts = spec.encode_int_block(idv[i])
        if (ie.payloads[i], int(ie.mins[i]), int(ie.bits[i])) != \
                (payload, mn, bts):
            raise AssertionError("sharded int block %d differs" % i)
    out["catalog_blocks"] = 2 * b
    out["peak_bytes_in_use"] = [
        (d.memory_stats() or {}).get("peak_bytes_in_use")
        for d in devices]
    return out


# -- driver ----------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--workdir", default=os.path.join(REPO, ".smoke_work"),
                    help="scratch directory (emptied before and after)")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print("chip_smoke: no GPU (JAX's default backend is %r); this "
              "script runs only on the card" % devs[0].platform,
              file=sys.stderr)
        return 2
    if len(devs) < args.cards:
        print("chip_smoke: --cards %d but JAX sees %d GPU(s)"
              % (args.cards, len(devs)), file=sys.stderr)
        return 2

    from minnow_tpu.utils import device

    device.ensure_compile_cache()
    clock = CompileClock()
    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    try:
        with phase("card", None) as info:
            info.update(card_info())
        if args.cards == 4:
            with phase("cards4", clock, "%d^3 particles, %d catalog rows"
                       % (SNAP_SIDE, CATALOG_ROWS)) as info:
                info.update(sharded_encode(devs[:4], SNAP_SIDE,
                                           CATALOG_ROWS, args.seed,
                                           args.workdir))
        else:
            with phase("exact", clock) as info:
                info.update(exact())
            with phase("minh", clock, "%d rows" % CATALOG_ROWS) as info:
                minh_path, res = minh_convert(args.workdir, CATALOG_ROWS,
                                              args.seed)
                info.update(res)
            with phase("minh_read", clock, "%d rows" % CATALOG_ROWS) \
                    as info:
                info.update(minh_read(minh_path))
            with phase("boundary", clock, "8 cells, boundary 5.0") as info:
                info.update(boundary(args.workdir, minh_path))
            with phase("minp", clock, "%d^3 particles in %d files"
                       % (SNAP_SIDE, SNAP_FILES)) as info:
                info.update(minp_convert(args.workdir, SNAP_SIDE,
                                         SNAP_FILES, args.seed))
            with phase("flagship", clock) as info:
                info.update(flagship(seed=args.seed))
    except Exception:  # noqa: BLE001 - the phase line says what failed
        return 1
    finally:
        shutil.rmtree(args.workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
