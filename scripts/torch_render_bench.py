"""Mesh-overlay rendering of the PyTorch port: painter against z-buffer,
on the host and on one NVIDIA card.

The port's counterpart of scripts/render_bench.py (which stays as it
is), on the same SMPL-scale mesh (a 6,966-vertex / 13,770-face sphere at
person-on-screen scale) over the same 1080p frame, REPS samples each:

  * painter        gaitlab_torch.render.raster.render_mesh (host, one
                   cv2.fillConvexPoly per face, back to front)
  * zbuffer_cpu    render/raster_torch.render_mesh_zbuffer on the CPU
  * zbuffer_card   the same on the card (host prep, the frame's upload,
                   the raster, the read-back)

Each sample ends with the host image the overlay needs (the z-buffer's
read-back to numpy synchronizes the card), so the host clock covers the
device work and the transfers. The painter's and the z-buffers' images
are compared pixel by pixel.

    python3 scripts/torch_render_bench.py
    python3 scripts/torch_render_bench.py --reps 2 --out /tmp/r.json
    python3 scripts/torch_render_bench.py --device cpu   # no card row

Writes docs/TORCH_RENDER_BENCH.json (or --out) with the card's name and
power limit. Without --device cpu, a box without CUDA raises.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import time

import numpy as np

from torch_precision_study import REPO
from torch_stage_timing import SEED, card

H, W = 1080, 1920
REPS = 12
CAM = [0.9, 0.9, 0.05, -0.1]  # person-scale on-screen footprint
OUT = osp.join(REPO, "docs", "TORCH_RENDER_BENCH.json")


def sphere_mesh(rings: int = 85, segs: int = 81):
    """UV sphere at SMPL scale: 6,966 verts / 13,770 faces (~SMPL's
    6,890/13,776), ~0.9 m tall so a gait-video person fills ~40% of 1080p
    height at the usual weak-perspective cam."""
    phi = np.linspace(0, np.pi, rings + 1)
    theta = np.linspace(0, 2 * np.pi, segs, endpoint=False)
    P, T = np.meshgrid(phi, theta, indexing="ij")
    verts = 0.45 * np.stack(
        [np.sin(P) * np.cos(T), np.cos(P), np.sin(P) * np.sin(T)],
        axis=-1).reshape(-1, 3)
    faces = []
    for i in range(rings):
        for j in range(segs):
            a = i * segs + j
            b = i * segs + (j + 1) % segs
            c = (i + 1) * segs + j
            d = (i + 1) * segs + (j + 1) % segs
            faces += [[a, b, c], [b, d, c]]
    return verts, np.asarray(faces, np.int64)


def timeit(fn, reps: int) -> tuple[float, np.ndarray]:
    """(mean host ms per call over reps, the last image), after two
    warm-up calls."""
    fn()
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) / reps * 1e3, out


def agreement(a: np.ndarray, b: np.ndarray, img: np.ndarray) -> float:
    """Share of the pixels either image painted on which they agree within
    8 levels in every channel."""
    changed = (a != img).any(-1) | (b != img).any(-1)
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
    return float((diff[changed] <= 8).mean())


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (raises without CUDA)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    from gaitlab_torch.device import resolve_device
    from gaitlab_torch.render import raster, raster_torch

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    verts, faces = sphere_mesh()
    img = np.random.default_rng(SEED).integers(0, 255, (H, W, 3)).astype(
        np.uint8)
    results, images = {}, {}
    runs = [("painter", lambda: raster.render_mesh(img, verts, CAM, faces)),
            ("zbuffer_cpu", lambda: raster_torch.render_mesh_zbuffer(
                img, verts, CAM, faces, device="cpu"))]
    if on_card:
        runs.append(("zbuffer_card", lambda: raster_torch.render_mesh_zbuffer(
            img, verts, CAM, faces, device=dev)))
    for name, fn in runs:
        ms, images[name] = timeit(fn, args.reps)
        results[name] = {"ms_per_person_frame": ms,
                         "person_frames_per_s": 1e3 / ms}
        print(f"[render_bench] {name}: {ms:.2f} ms per person-frame",
              file=sys.stderr, flush=True)
    agree = {f"painter_vs_{k}": agreement(images["painter"], images[k], img)
             for k in images if k != "painter"}
    if on_card:
        agree["zbuffer_card_vs_cpu_equal"] = float(
            (images["zbuffer_card"] == images["zbuffer_cpu"]).all(-1).mean())
    best = min(results, key=lambda k: results[k]["ms_per_person_frame"])
    doc = {"script": "scripts/torch_render_bench.py",
           "card": card() if on_card else None,
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "torch": torch.__version__,
           "mesh": {"verts": int(verts.shape[0]),
                    "faces": int(faces.shape[0])},
           "frame": f"{W}x{H}", "reps": args.reps,
           "method": "host clock, mean of reps after two warm-ups; each "
                     "sample ends with the host image (read-back included)",
           "results": results, "pixel_agreement": agree, "fastest": best,
           "render_2000_frames_s": 2000 * results[best][
               "ms_per_person_frame"] / 1e3}
    os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
