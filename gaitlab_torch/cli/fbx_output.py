"""Keyframed animated skinned SMPL export CLI.

Counterpart of gaitlab/cli/fbx_output.py, flag for flag (the reference's
Blender-driven entry point: --input/--output/--fps_source/--fps_target/
--gender/--start_origin/--person_id), without the Blender dependency:
`.fbx` outputs go through the binary writer (render/fbx.py), `.glb`
through the glTF writer (render/export.py). The skinning data is computed
on the card unless `main` is given device="cpu".

Usage:
    python -m gaitlab_torch.cli.fbx_output --input out/demo_output.pkl \
        --output mesh_anim.fbx [--gender female] [--person_id 1]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None, device=None) -> int:
    """Parse `argv` and export; `device` None is the card."""
    parser = argparse.ArgumentParser(
        description="Create keyframed animated skinned SMPL mesh "
                    "from demo output")
    parser.add_argument("--input", dest="input_path", type=str,
                        required=True, help="Input demo .pkl file")
    parser.add_argument("--output", dest="output_path", type=str,
                        required=True, help="Output .fbx or .glb file")
    parser.add_argument("--fps_source", type=int, default=30)
    parser.add_argument("--fps_target", type=int, default=30)
    parser.add_argument("--gender", type=str, default="male")
    parser.add_argument("--start_origin", type=int, default=1)
    parser.add_argument("--person_id", type=int, default=None,
                        help="Person id in the pkl (default: longest "
                             "track, matching demo rendering order)")
    args = parser.parse_args(argv)

    if not os.path.exists(args.input_path):
        print("ERROR: Invalid input path")
        return 1
    out = args.output_path
    out_dir = os.path.dirname(out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    from gaitlab_torch.cli.demo import load_pickle

    results = load_pickle(args.input_path)
    person_id = args.person_id
    if person_id is None:
        person_id = max(results.keys(),
                        key=lambda k: len(results[k]["frame_ids"]))
    if person_id not in results:
        print(f"ERROR: person_id {person_id} not in "
              f"{sorted(results.keys())}")
        return 1
    person = results[person_id]
    pose = np.asarray(person["pose"], np.float32)

    # fps_target <= fps_source; integer decimation like the reference
    fps_target = min(args.fps_target, args.fps_source)
    step = max(1, int(args.fps_source / fps_target))
    pose = pose[::step]
    trans = np.zeros((pose.shape[0], 3), np.float32)
    if args.start_origin:
        trans -= trans[:1]  # reference semantics; no-op for zero trans

    if out.endswith(".fbx"):
        from gaitlab_torch.render import fbx

        print("Exporting to FBX binary (.fbx)")
        fbx.export_fbx(out, pose, person["betas"], trans=trans,
                       fps=float(fps_target), gender=args.gender,
                       device=device)
    elif out.endswith(".glb"):
        from gaitlab_torch.render import export

        print("Exporting to glTF binary (.glb)")
        export.export_glb(out, pose, person["betas"], trans=trans,
                          fps=float(fps_target), device=device)
    else:
        print("ERROR: Unsupported export format: " + out)
        return 1
    print(f"Exported {pose.shape[0]} frames -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
