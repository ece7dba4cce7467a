"""minh_to_bnd: convert basic minh catalogs to the spatial boundary
layout (ref scripts/minh_to_bnd.go).

Usage:
  python -m minnow_tpu.cli.minh_to_bnd <cells> <boundary> <glob> <outdir>
        [--device]

With ``--device`` column reads run through the batched device decoder
(formats/minh_device.py) and cell-group writes through the batched
device encoder (formats/boundary_device.py).

Note on bytes: this conversion re-encodes *dithered* decodes (as the
reference does with Go's unseeded RNG, ref go/group.go:308), so output
bytes depend on the dither stream.  Host and device readers compute one
defined stream in every mode (core/dither.py), so host and device runs
produce byte-identical boundary files.
"""

from __future__ import annotations

import glob as globmod
import os
import sys
import time

import numpy as np

from ..formats import boundary, minh


def out_name(out_dir: str, fname: str) -> str:
    """(ref minh_to_bnd.go:41-50)"""
    base = os.path.basename(fname)
    toks = base.split(".")
    toks = toks[:-1] + ["bnd", "minh"] if len(toks) > 1 \
        else [base, "bnd", "minh"]
    return os.path.join(out_dir, ".".join(toks))


def convert_file(in_name: str, out_name_: str, cells: int,
                 bnd: float, device: bool = False,
                 dither: str = "uniform") -> None:
    """(ref minh_to_bnd.go:52-78)"""
    rd = minh.open(in_name, dither=dither)
    w = boundary.create_boundary(out_name_)
    if device:
        from ..formats import minh_device
        from ..formats.boundary_device import DeviceBoundaryWriter

        w = DeviceBoundaryWriter(w)
        read_floats = lambda names: minh_device.read_floats(  # noqa: E731
            rd, names, dither=dither)
        read_ints = lambda names: minh_device.read_ints(rd, names)  # noqa: E731
    else:
        read_floats = rd.floats
        read_ints = rd.ints
    w.header(rd.text)
    w.geometry(rd.l, np.float32(bnd), cells)

    def read_col(name):
        # compressed columns decode on device; raw fixed columns are a
        # plain host memcpy
        col = rd.columns[rd.names.index(name)]
        if col.type == minh.Float:
            return read_floats([name])[name]
        if col.type == minh.Int:
            return read_ints([name])[name]
        if col.type == minh.Float32:
            return rd.floats([name])[name]
        if col.type == minh.Int64:
            return rd.ints([name])[name]
        return None

    w.coordinates(read_col("x"), read_col("y"), read_col("z"))

    for i, name in enumerate(rd.names):
        data = read_col(name)
        if data is not None:
            w.column(name, rd.columns[i], data)
    w.close()
    rd.close()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "--device" in argv
    if device:
        argv.remove("--device")
        from ..utils import device as device_mod

        device_mod.announce("minh_to_bnd")
    if len(argv) != 4:
        raise SystemExit(__doc__)
    cells = int(argv[0])
    bnd = float(argv[1])
    for fname in globmod.glob(argv[2]):
        print("Converting", fname)
        t0 = time.time()
        convert_file(fname, out_name(argv[3], fname), cells, bnd,
                     device=device)
        print("    %.2f minutes" % ((time.time() - t0) / 60))


if __name__ == "__main__":
    main()
