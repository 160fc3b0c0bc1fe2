#!/usr/bin/env python3
"""Times the port's two CUDA kernels on one card (needs CUDA and nvcc).

    python3 scripts/torch_kernel_study.py ab TREE [TREE ...]
    python3 scripts/torch_kernel_study.py ablate

`ab` times keypoint_attention_fused (B1) and blendshapes (B2) at B = 128,
the main path's shapes, from the gaitlab_torch package of each TREE in
turn, each in its own process (pass a parent checkout and this one as
PARENT . . PARENT to compare two commits on one card). `ablate` builds
variants of this checkout's blendshapes kernel with one part taken out
(the MMAs, the output stores) and a sweep over the pose coefficients, to
show where its time goes; a variant's output is not checked. Times are
chip_smoke.py's: median device time of one call, CUDA events, L2 flushed
before each call. Each line of output is one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import os
import os.path as osp
import subprocess
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
B = 128


def inputs(gen):
    import torch

    v, s, p = 6890, 10, 207
    bs = (torch.randn(v, 3, device="cuda", generator=gen) * 0.3,
          torch.randn(v, 3, s, device="cuda", generator=gen) * 0.01,
          torch.randn(p, v * 3, device="cuda", generator=gen) * 0.001,
          torch.randn(B, s, device="cuda", generator=gen),
          torch.randn(B, p, device="cuda", generator=gen) * 0.5)
    f = torch.randn(B, 128, 56, 56, device="cuda", generator=gen).relu()
    c = torch.randn(B, 64, 56, 56, device="cuda", generator=gen)
    hm = torch.randn(B, 25, 56, 56, device="cuda", generator=gen) * 3
    at = (f.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1),
          hm[:, 1:].permute(0, 2, 3, 1))
    return bs, at


def time_tree(tree: str) -> None:
    """One tree's kernels, in this process (called by `ab`)."""
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, time_ms

    sys.path.insert(0, osp.abspath(tree))
    from gaitlab_torch.device import float32_math
    from gaitlab_torch.ops import _build
    from gaitlab_torch.ops.blendshapes import blendshapes, blendshapes_plain
    from gaitlab_torch.ops.keypoint_attention import (
        keypoint_attention_fused, keypoint_attention_plain)

    assert osp.abspath(_build.SRC_DIR).startswith(osp.abspath(tree))
    _build.build_all()
    bs, at = inputs(torch.Generator(device="cuda").manual_seed(0))
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    with float32_math():
        err_b2 = (blendshapes(*bs) - blendshapes_plain(*bs)).abs().max().item()
        err_b1 = max((x - y).abs().max().item() for x, y in zip(
            keypoint_attention_fused(*at), keypoint_attention_plain(*at)))
        row = {"tree": tree, "card": card_line(), "batch": B,
               "b1_ms": time_ms(lambda: keypoint_attention_fused(*at), flush),
               "b1_err": err_b1,
               "b2_ms": time_ms(lambda: blendshapes(*bs), flush),
               "b2_err": err_b2}
    print(json.dumps(row), flush=True)


def ab(trees: list) -> None:
    for tree in trees:
        subprocess.run([sys.executable, osp.abspath(__file__), "_time", tree],
                       check=True)


# blendshapes variants: name -> (text in csrc/blendshapes.cu, replacement)
ABLATIONS = {
    "no_mma": ("""          mma(acc[m][n], as, bb[n][0], bb[n][1]);
          mma(acc[m][n], ab, bs[n][0], bs[n][1]);
          mma(acc[m][n], ab, bb[n][0], bb[n][1]);""",
               "          acc[m][n][0] += __uint_as_float("
               "ab[0] ^ bb[n][0] ^ as[1] ^ bs[n][1]);"),
    "no_stores": ("  for (int b = warp; b < nb; b += kThreads / 32) {",
                  "  for (int b = warp; b < 0; b += kThreads / 32) {"),
}


def ablate() -> None:
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, time_ms
    from gaitlab_torch.ops import _build
    from gaitlab_torch.ops import blendshapes as bsm

    libs = dict(_build.build_all())
    src = open(osp.join(_build.SRC_DIR, "blendshapes.cu")).read()
    out_dir = osp.join(_build.BUILD_DIR, "study")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (old, new) in ABLATIONS.items():
        assert old in src, name
        cu = osp.join(out_dir, f"blendshapes_{name}.cu")
        with open(cu, "w") as f:
            f.write(src.replace(old, new))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu])
    variants = {"full": libs["blendshapes"]}
    fn, argtypes = _build.SIGNATURES["blendshapes"]
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}")
        lib = ctypes.CDLL(osp.join(out_dir, f"blendshapes_{name}.so"))
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        lib.gaitlab_cuda_error_string.argtypes = (ctypes.c_int,)
        lib.gaitlab_cuda_error_string.restype = ctypes.c_char_p
        variants[name] = lib

    gen = torch.Generator(device="cuda").manual_seed(0)
    bs, _ = inputs(gen)
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    card = card_line()
    try:
        for name, lib in variants.items():
            _build._libs["blendshapes"] = lib
            ms = time_ms(lambda: bsm.blendshapes(*bs), flush)
            print(json.dumps({"card": card, "variant": name, "batch": B,
                              "pose": 207, "b2_ms": ms}), flush=True)
    finally:
        _build._libs["blendshapes"] = libs["blendshapes"]
    vt, sh, po, be, pf = bs
    for p in (16, 112):  # fewer pose coefficients: the cost per chunk of K
        args = (vt, sh, po[:p].contiguous(), be, pf[:, :p].contiguous())
        ms = time_ms(lambda: bsm.blendshapes(*args), flush)
        print(json.dumps({"card": card, "variant": "full", "batch": B,
                          "pose": p, "b2_ms": ms}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_study: CUDA is not available", file=sys.stderr)
        return 1
    cmd, args = (sys.argv[1], sys.argv[2:]) if len(sys.argv) > 1 else ("", [])
    if cmd == "ab" and args:
        ab(args)
    elif cmd == "_time" and len(args) == 1:
        time_tree(args[0])
    elif cmd == "ablate":
        ablate()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
