#!/usr/bin/env python
"""Data-layout checker and preparer for the PyTorch port.

The port's counterpart of scripts/prepare_data.py (which stays as it
is), with the same command line, report and exit code. It downloads
nothing: it checks the expected layout under --root, copies each missing
file from a local mirror when one has it (GAITLAB_ASSET_DIR, searched
recursively by gaitlab_torch.pipeline.fetch.resolve_asset), and prints
what is still missing and where it goes. Host only: no card needed.

    python3 scripts/torch_prepare_data.py [--root .]

Exit code 1 when a file is still missing, 0 when all are present.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil
import sys

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

EXPECTED = [
    ("data/smpl_data/SMPL_NEUTRAL.pkl", "official SMPL neutral body model"),
    ("data/smpl_data/J_regressor_extra.npy", "SPIN extra-joint regressor"),
    ("data/smpl_data/smpl_mean_params.npz", "SMPL mean parameters"),
    ("data/grnet_data/hrnet_w32.pth.tar", "HRNet-W32 backbone checkpoint"),
    ("data/grnet_data/pare_w_3dpw_checkpoint.ckpt", "PARE head checkpoint"),
    ("checkpoint/max-grnet.pth.tar", "MAX-GRNet deployed checkpoint"),
    ("sample_video.mp4", "demo sample clip (optional)"),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".", help="repo/data root")
    args = ap.parse_args(argv)

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from gaitlab_torch.pipeline import fetch

    missing = []
    for rel, desc in EXPECTED:
        dst = osp.join(args.root, rel)
        if osp.isfile(dst):
            print(f"[ok]      {rel}")
            continue
        try:
            src = fetch.resolve_asset(osp.basename(rel))
            os.makedirs(osp.dirname(dst) or ".", exist_ok=True)
            shutil.copy(src, dst)
            print(f"[copied]  {rel}  <- {src}")
        except FileNotFoundError:
            print(f"[MISSING] {rel}  ({desc})")
            missing.append(rel)

    if missing:
        print("\nPlace the files above (fetch them on a connected machine, "
              "or set GAITLAB_ASSET_DIR to a local mirror) and re-run.")
        return 1
    print("\nAll data present.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
