"""Deployment CLI: version-pinned serving from torch.export artifacts.

Counterpart of gaitlab/cli/serve.py. A build step exports and pins the
program once; serving hosts run the pinned programs with no Python model
code.

  # build box (with the card): checkpoint -> self-contained directory
  python -m gaitlab_torch.cli.serve export --ckpt max-grnet.pth.tar \\
      --smpl_model data/smpl_data/SMPL_NEUTRAL.pkl --artifacts art/

  # serving box: artifact directory -> per-track pkl (the demo's schema)
  python -m gaitlab_torch.cli.serve run --artifacts art/ \\
      --vid_file clinic_walk.mp4 --output_folder out/

`run` drives the same one-pass pipeline as `demo --onepass` (one decode,
streaming detect/track/crop, bucketed padded dispatch); only the
per-bucket forward is the loaded program (gaitlab_torch/serve.py
::load_runner), and the weights come from the directory (weights.npz).
Both run on the card; `main_cli(argv, device="cpu")` runs on the CPU
(`export` then writes the `cpu` programs only when --platforms says so).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
import sys
import time

# the trunk that crop sizes other than 224 build (tests, edge devices): a
# narrow HRNet with every branch, fuse and head path of the full one
SMALL_TRUNK = dict(backbone_width=8, num_input_features=120,
                   num_features_pare=32, num_features_smpl=16,
                   backbone_modules=(1, 1, 1), backbone_blocks=1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser("export", help="checkpoint -> artifact directory")
    ex.add_argument("--artifacts", type=str, required=True,
                    help="output artifact directory")
    ex.add_argument("--ckpt", type=str, default=None,
                    help="pretrained GRNet checkpoint (.pth.tar)")
    ex.add_argument("--cfg", type=str, default=None, help="yacs yaml")
    ex.add_argument("--smpl_model", type=str, default=None,
                    help="SMPL_*.pkl body model file")
    ex.add_argument("--buckets", type=str, default=None,
                    help="comma-separated batch buckets to export "
                         "(default: the runner's bucket set)")
    ex.add_argument("--platforms", type=str, default="cuda,cpu",
                    help="devices to export programs for (default "
                         "cuda,cpu; each must be present)")
    ex.add_argument("--precision", type=str, default=None,
                    help="matmul precision: float32 (the default, TF32 "
                         "off), high or default (TF32 passes; "
                         "nn/layers.py says what each means on the "
                         "card)")
    ex.add_argument("--crop_size", type=int, default=224,
                    help="crop resolution; other sizes build a small "
                         "(test/edge) trunk with random weights")

    rn = sub.add_parser("run", help="artifact directory -> joints pkl")
    rn.add_argument("--artifacts", type=str, required=True)
    rn.add_argument("--vid_file", type=str, required=True)
    rn.add_argument("--output_folder", type=str, default="output/")
    rn.add_argument("--detector", type=str, default="median_bg",
                    choices=["yolo", "dnn", "median_bg"])
    rn.add_argument("--joint_type", type=str, default="spin2")
    rn.add_argument("--smooth", action="store_true")
    rn.add_argument("--smooth_min_cutoff", type=float, default=0.004)
    rn.add_argument("--smooth_beta", type=float, default=1.5)
    return p


def main_export(args, device=None) -> int:
    from gaitlab_torch import serve
    from gaitlab_torch.cli import demo as demo_cli
    from gaitlab_torch.pipeline.runner import GRNetRunner

    if args.crop_size == 224:
        model = demo_cli.build_model(args.ckpt, args.smpl_model,
                                     device=device)
    else:
        from gaitlab_torch.nn.grnet import GRNet

        if args.ckpt:
            print("WARNING: --ckpt ignored for non-224 crop sizes "
                  "(checkpoint layouts are 224-trained)")
        model = GRNet.create(device=device, **SMALL_TRUNK)

    kw = {"crop_size": args.crop_size}
    if args.buckets:
        kw["buckets"] = tuple(int(b) for b in args.buckets.split(",") if b)
    if args.precision:
        kw["precision"] = args.precision
    runner = GRNetRunner(model, **kw)
    platforms = tuple(p for p in args.platforms.split(",") if p)
    t0 = time.time()
    manifest = serve.save_artifacts(runner, args.artifacts,
                                    platforms=platforms)
    n = len(manifest["files"])
    print(f"Exported {n} bucket programs + weights to {args.artifacts} "
          f"in {time.time() - t0:.1f}s "
          f"(precision={manifest['precision']}, "
          f"head={manifest['head_precision']}, "
          f"trunk_dtype={manifest['trunk_dtype']}, "
          f"platforms={manifest['platforms']})")
    return 0


def main_run(args, device=None) -> int:
    from gaitlab_torch import serve
    from gaitlab_torch.cli.demo import _person_output
    from gaitlab_torch.pipeline import detect
    from gaitlab_torch.pipeline import stream as stream_mod
    from gaitlab_torch.pipeline import video as video_mod

    if not osp.isfile(args.vid_file):
        print(f"Input video does not exist: {args.vid_file}")
        return 1
    t0 = time.time()
    runner = serve.load_runner(args.artifacts, device=device)
    print(f"Loaded {len(runner.buckets)} pinned programs "
          f"(buckets {list(runner.buckets)}, "
          f"precision={runner.precision}, "
          f"head={runner.resolved_head_precision()}, "
          f"trunk_dtype={runner.trunk_dtype}) from {args.artifacts} in "
          f"{time.time() - t0:.1f}s")

    detector = detect.get_detector(args.detector, device=runner.model.device)
    t0 = time.time()
    res = stream_mod.run_video_onepass(runner, args.vid_file,
                                       detector=detector)
    _n, _fps, w, h = video_mod.get_video_info(args.vid_file)
    results = {pid: _person_output(out, out["bboxes"], out["frames"], pid,
                                   args, runner.model, w, h)
               for pid, out in res.items()}
    dt = time.time() - t0

    os.makedirs(args.output_folder, exist_ok=True)
    base = osp.splitext(osp.basename(args.vid_file))[0]
    pkl = osp.join(args.output_folder, f"{base}_serve_output.pkl")
    with open(pkl, "wb") as f:  # a plain pickle, as the demo writes
        pickle.dump(results, f)
    n_frames = len({int(f) for r in results.values()
                    for f in r["frame_ids"]})
    fps = n_frames / dt if dt > 0 else float("nan")
    print(f"{len(results)} tracks, {n_frames} frames in {dt:.1f}s "
          f"({fps:.1f} fps) -> {pkl}")
    return 0


def main_cli(argv=None, device=None) -> int:
    """Parse `argv` and export or run; `device` None is the card."""
    args = build_parser().parse_args(argv)
    return (main_export(args, device) if args.cmd == "export"
            else main_run(args, device))


if __name__ == "__main__":
    sys.exit(main_cli())
