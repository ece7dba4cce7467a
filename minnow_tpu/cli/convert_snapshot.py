"""convert_snapshot: convert particle snapshots between LGadget-2 and
minp (ref scripts/convert_snapshot.go -- which does not compile as
committed; this implements its evident intent, SURVEY App. B #1).

Usage:
  python -m minnow_tpu.cli.convert_snapshot to_minp <in_dir> <out_dir> \
      <file_cells> <sub_cells> <dx> <dv> [--device]
  python -m minnow_tpu.cli.convert_snapshot to_lgadget2 <in_dir> \
      <fname_fmt> <out_dir>

With ``--device`` the minp vector encode runs through the batched
device pipeline (parallel.BlockEncoder); output bytes are identical to
the host writer, and a dead backend downgrades to the host path with a
warning instead of hanging.
"""

from __future__ import annotations

import sys

from ..ingest import lgadget2, snapshot


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "--device" in argv
    if device:
        argv.remove("--device")
        from ..utils import device as device_mod

        device_mod.announce("convert_snapshot")
    if not argv:
        raise SystemExit(__doc__)
    mode = argv[0]
    if mode == "to_minp":
        if len(argv) != 7:
            raise SystemExit(__doc__)
        in_dir, out_dir = argv[1], argv[2]
        file_cells, sub_cells = int(argv[3]), int(argv[4])
        dx, dv = float(argv[5]), float(argv[6])
        snap = lgadget2.LGadget2Snapshot(in_dir)
        encoder = None
        if device:
            from ..parallel import BlockEncoder

            encoder = BlockEncoder()
        snapshot.write_minp(out_dir, "%s_%d.minp", file_cells, sub_cells,
                            dx, dv, snap, encoder=encoder)
    elif mode == "to_lgadget2":
        if len(argv) != 4:
            raise SystemExit(__doc__)
        in_dir, fname_fmt, out_dir = argv[1], argv[2], argv[3]
        snap = snapshot.MinPSnapshot(in_dir, fname_fmt)
        hd = snap.header()
        gh = lgadget2.LGadget2Header(
            time=hd.scale, redshift=hd.z, box_size=hd.l,
            omega0=hd.omega_m, omega_lambda=hd.omega_l,
            hubble_param=hd.h100,
            n_part_total=(int(hd.n_total >> 32),
                          int(hd.n_total & 0xFFFFFFFF), 0, 0, 0, 0),
            num_files=snap.files())
        lgadget2.write_lgadget2(out_dir, "snap_%03d.dat", snap, gh)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
