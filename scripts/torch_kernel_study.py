#!/usr/bin/env python3
"""Times the port's two CUDA kernels on one card (needs CUDA and nvcc).

    python3 scripts/torch_kernel_study.py ab TREE [TREE ...]
    python3 scripts/torch_kernel_study.py ablate
    python3 scripts/torch_kernel_study.py ablate_bf16
    python3 scripts/torch_kernel_study.py gait
    python3 scripts/torch_kernel_study.py queue
    python3 scripts/torch_kernel_study.py serve
    python3 scripts/torch_kernel_study.py dp

`ab` times keypoint_attention_fused (B1) and blendshapes (B2) at B = 128,
the main path's shapes, from the gaitlab_torch package of each TREE in
turn, each in its own process (pass a parent checkout and this one as
PARENT . . PARENT to compare two commits on one card). `ablate` builds
variants of this checkout's blendshapes kernel with one part taken out
(the MMAs, the output stores) and a sweep over the pose coefficients, to
show where its time goes; a variant's output is not checked. Times are
chip_smoke.py's: median device time of one call, CUDA events, L2 flushed
before each call. Each line of output is one JSON object.

`ablate_bf16` does the same for B1 on bf16 inputs
(csrc/keypoint_attention_bf16.cu) at B = 128 on the head's views, twice
in turns: the TMA traffic alone (each tile handed back on arrival, with
and without the first pass over the logits), the softmax step without the
wgmmas, no L2 eviction hints, a ring of 6 stages, and part 0's sums
chained over the whole frame on the tensor cores (where the kernel adds
each tile's with an FP32 add), with each variant's error against float64
(meaningless for the first three); then, on the same values, the FP32
kernel, one scaled_dot_product_attention in bf16, and a copy of the
features tensor as a yardstick of the card's streaming rate.

`gait` studies MAX-GRNet's gait corrector at full width (random weights
from seed 0, random crops): at buckets 256 and 450 the model with and
without the branch, with the card drained before the corrector (a
synchronising pre-hook, as any host-to-card copy from pageable memory
inside the forward would be) and the corrector alone (CUDA events, median
of 5); a profile of the corrector alone; the corrector alone on the same
features on the card and on the CPU; and a 900-frame track cropped on
the host and fed to a ForwardStream 32 frames at a time, as the port runs
it (forwards on the session's worker thread, pinned asynchronous copies),
with the forwards on the caller's thread, and with pageable `.to()`
copies (host ms of the crops, the feeds and finish(), wall). Its profile
lines are plain text.

`queue` measures how many kernel launches the host can queue ahead of the
card (tiny launches behind a sleep kernel of about 200 ms) and how long
GRNet's and MAX-GRNet's forwards at bucket 450 keep the launching thread
(host ms of the call, and the ms the card still runs after it returns).

`serve` studies a pinned serving program (gaitlab_torch/serve.py) of
full-width GRNet at bucket 128 (random weights from seed 0, random uint8
crops): export seconds and graph nodes, where loading goes
(torch.export.load, ExportedProgram.module(), weights.npz, the upload),
the host ms of the program's input checks over its inputs, and the
program's ms with and without those checks beside the live model's (CUDA
events, median of 20), twice.

`dp` studies data parallelism over two replicas of full-width GRNet that
share the card (parallel/replicas.py; random weights from seed 0, random
crops): at 32 and 256 rows, the forward (inference mode) and, at 32 rows,
the train step's forward and backward (the head's loss on random
labels), each three ways: on one device, over the two replicas with one
launching thread and stream each (parallel_apply), and over the two
replicas launched one after the other from the caller's thread on its
stream. Host ms of a call ended by a synchronize, median of 5.
"""

from __future__ import annotations

import ctypes
import json
import os
import os.path as osp
import subprocess
import sys
import time

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
    "no_mma": [("""          mma(acc[m][n], as, bb[n][0], bb[n][1]);
          mma(acc[m][n], ab, bs[n][0], bs[n][1]);
          mma(acc[m][n], ab, bb[n][0], bb[n][1]);""",
                "          acc[m][n][0] += __uint_as_float("
                "ab[0] ^ bb[n][0] ^ as[1] ^ bs[n][1]);")],
    "no_stores": [("  for (int b = warp; b < nb; b += kThreads / 32) {",
                   "  for (int b = warp; b < 0; b += kThreads / 32) {")],
}

# keypoint_attention_bf16 variants: name -> [(text, replacement)]
_BF16_TILE_WAIT = """    mbar_wait(&full[st], (it / kStages) & 1);
    uint8_t* stage = base + st * kStageBytes;
"""
_BF16_STREAM = (_BF16_TILE_WAIT, _BF16_TILE_WAIT.replace(
    "    uint8_t* stage",
    "    if (t >= 0) {\n      mbar_arrive(&empty[st]);\n      ++it;\n"
    "      return;\n    }\n    uint8_t* stage"))
BF16_ABLATIONS = {
    "stream_only": [_BF16_STREAM],
    "stream_no_scan": [_BF16_STREAM, (
        "const int n_scan = (n_tiles + kScan - 1) / kScan;",
        "const int n_scan = 0;")],
    "no_wgmma": [("      if (mb < n_mb) {\n        const uint64_t ad",
                  "      if (mb < n_mb && t < 0) {\n        const uint64_t ad")],
    "no_l2_hints": [("L2::evict_first.b64", "L2::evict_unchanged.b64"),
                    ("L2::evict_last.b64", "L2::evict_unchanged.b64")],
    "stages6": [("constexpr int kStages = 4; ", "constexpr int kStages = 6; ")],
    "chained_part0": [
        ("wgmma_m64n24k16(cur[mb], ad + 2 * k, w0 + 2 * k, k > 0);",
         "wgmma_m64n24k16(sum0[mb], ad + 2 * k, w0 + 2 * k, 1);"),
        ("sum0[mb][i] += done[mb][i];", "(void)done[mb][i];"),
        ("      fence_operands(cur[mb]);\n",
         "      fence_operands(cur[mb]);\n      fence_operands(sum0[mb]);\n"),
        ("    fence_operands(fresh[1][mb]);\n",
         "    fence_operands(fresh[1][mb]);\n    fence_operands(sum0[mb]);\n")],
}


def variant_libs(kernel: str, ablations: dict) -> dict:
    """{name: loaded library} of csrc/<kernel>.cu as built ("full") and
    of each ablation, its replacements applied, built with the build's
    flags (one nvcc each, in parallel) into the build directory."""
    from gaitlab_torch.ops import _build

    libs = {"full": _build.build_all()[kernel]}
    src = open(osp.join(_build.SRC_DIR, f"{kernel}.cu")).read()
    out_dir = osp.join(_build.BUILD_DIR, "study")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in ablations.items():
        text = src
        for old, new in subs:
            assert text.count(old) >= 1, (name, old)
            text = text.replace(old, new)
        cu = osp.join(out_dir, f"{kernel}_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.SRC_DIR, "-o",
             cu[:-3] + ".so", cu])
    fn, argtypes = _build.SIGNATURES[kernel]
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}")
        lib = ctypes.CDLL(osp.join(out_dir, f"{kernel}_{name}.so"))
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        lib.gaitlab_cuda_error_string.argtypes = (ctypes.c_int,)
        lib.gaitlab_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def ablate() -> None:
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, time_ms
    from gaitlab_torch.ops import _build
    from gaitlab_torch.ops import blendshapes as bsm

    variants = variant_libs("blendshapes", ABLATIONS)
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
        _build._libs["blendshapes"] = variants["full"]
    vt, sh, po, be, pf = bs
    for p in (16, 112):  # fewer pose coefficients: the cost per chunk of K
        args = (vt, sh, po[:p].contiguous(), be, pf[:, :p].contiguous())
        ms = time_ms(lambda: bsm.blendshapes(*args), flush)
        print(json.dumps({"card": card, "variant": "full", "batch": B,
                          "pose": p, "b2_ms": ms}), flush=True)


def ablate_bf16() -> None:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, time_ms
    from gaitlab_torch.ops import _build
    from gaitlab_torch.ops import keypoint_attention as ka

    variants = variant_libs("keypoint_attention_bf16", BF16_ABLATIONS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    f = torch.randn(B, 128, 56, 56, device="cuda", generator=gen).relu().to(bf)
    c = torch.randn(B, 64, 56, 56, device="cuda", generator=gen).to(bf)
    hm = (torch.randn(B, 25, 56, 56, device="cuda", generator=gen) * 3).to(bf)
    at = (f.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1),
          hm[:, 1:].permute(0, 2, 3, 1))
    ref64 = ka.keypoint_attention_plain(*(a.double() for a in at))
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    card = card_line()
    stages, smem = ka.BF16_STAGES, ka.BF16_SMEM
    try:
        for name in [*variants] * 2:
            _build._libs["keypoint_attention_bf16"] = variants[name]
            # a ring of another depth: the plan's shared memory with it
            n = 6 if name == "stages6" else stages
            ka.BF16_SMEM = smem + (n - stages) * (ka.BF16_STAGE_BYTES + 16)
            got = ka.keypoint_attention_fused(*at)
            err = max((g - r).abs().max().item() for g, r in zip(got, ref64))
            ms = time_ms(lambda: ka.keypoint_attention_fused(*at), flush)
            print(json.dumps({"card": card, "variant": name, "batch": B,
                              "b1_bf16_ms": ms, "err_f64": err}), flush=True)
    finally:
        _build._libs["keypoint_attention_bf16"] = variants["full"]
        ka.BF16_SMEM = smem
    q = torch.eye(24, device="cuda", dtype=bf).expand(B, 1, 24, 24).contiguous()
    k = hm[:, 1:].reshape(B, 1, 24, -1).transpose(2, 3).contiguous()
    v = torch.cat([f, c], 1).reshape(B, 1, 192, -1).transpose(2, 3).contiguous()
    f32 = tuple(a.float() for a in at)
    copy = torch.empty_like(f)
    copy_ms = time_ms(lambda: copy.copy_(f), flush)
    print(json.dumps({
        "card": card, "batch": B,
        "fp32_kernel_ms": time_ms(lambda: ka.keypoint_attention_fused(*f32),
                                  flush),
        "sdpa_bf16_ms": time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0), flush),
        "copy_ms": copy_ms, "copy_bytes": 2 * 2 * f.numel(),
        "copy_tb_per_s": 4 * f.numel() / copy_ms / 1e9}), flush=True)


def gait() -> None:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, profiled
    from gaitlab_torch.device import float32_math
    from gaitlab_torch.nn.gait import camera_reparam
    from gaitlab_torch.nn.grnet import GRNet
    from gaitlab_torch.pipeline import runner as runner_mod

    card = card_line()

    def emit(**row):
        print(json.dumps({"card": card, **row}), flush=True)

    def events_ms(fn, reps=5):
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    plain = GRNet.create(seed=0)
    model = GRNet.create(seed=0, use_gait_feat=True)
    core = model.module
    gen = torch.Generator(device="cuda").manual_seed(0)
    crops = torch.randn(450, 224, 224, 3, device="cuda", generator=gen)
    rng = np.random.default_rng(0)
    bbox = np.column_stack([rng.uniform(100, 220, (450, 2)),
                            np.full((450, 2), 120.0)]).astype(np.float32)
    cimg = np.tile(np.float32([160.0, 120.0]), (450, 1))

    def features(x, bb, ci):
        feats = core.head.feature_extractor(
            core.backbone(x.permute(0, 3, 1, 2).contiguous()))
        cam = core.head.predict(feats["point_local_feat"],
                                feats["cam_shape_feats"])["pred_cam"]
        return feats["point_local_feat"], camera_reparam(cam, bb, ci)

    correctors = {}
    for b in (256, 450):
        x, bb, ci = crops[:b], bbox[:b], cimg[:b]
        ms = {"plain": events_ms(lambda: plain.forward(x)),
              "gait": events_ms(lambda: model.forward(
                  x, bbox=bb, cimg=ci, n_valid=b))}
        drain = core.pfeat_corrector.register_forward_pre_hook(
            lambda m, a: torch.cuda.synchronize())
        try:
            ms["drained"] = events_ms(lambda: model.forward(
                x, bbox=bb, cimg=ci, n_valid=b))
        finally:
            drain.remove()
        with float32_math(), torch.inference_mode():
            feats, cp = features(x, torch.from_numpy(bb).cuda(),
                                 torch.from_numpy(ci).cuda())

            n_valid = torch.tensor([b], device="cuda")

            def corrector(feats=feats, cp=cp, n_valid=n_valid):
                core.pfeat_corrector(feats[None], cp[None], n_valid)

            ms["corrector"] = events_ms(corrector)
        correctors[b] = corrector
        emit(study="gait_loop", bucket=b, **{f"{k}_ms": v
                                              for k, v in ms.items()})
    with float32_math(), torch.inference_mode():
        profiled("the corrector alone at bucket 256", correctors[256], 6)
    del correctors

    # the corrector alone on the same features, card against CPU
    n = 32
    cpu_corr = GRNet.create(seed=0, device="cpu",
                            use_gait_feat=True).module.pfeat_corrector
    cpu_corr.load_state_dict({k: v.cpu() for k, v in
                              core.pfeat_corrector.state_dict().items()})
    with float32_math(), torch.inference_mode():
        feats, cp = features(crops[:n], torch.from_numpy(bbox[:n]).cuda(),
                             torch.from_numpy(cimg[:n]).cuda())
        got = core.pfeat_corrector(feats[None], cp[None], [n])
        want = cpu_corr(feats[None].cpu(), cp[None].cpu(), [n])
    emit(study="corrector_card_vs_cpu", frames=n, **{
        k: {"max_abs": (g.cpu() - w).abs().max().item(),
            "max_cpu": w.abs().max().item()}
        for k, g, w in zip(("corrected", "pred_avg", "pred_phase"),
                           got, want)})
    del crops, feats, cp, got
    torch.cuda.empty_cache()

    # a two-forward track through ForwardStream, cropped on the host 32
    # frames at a time as the one-pass pipeline does: the port (forwards on
    # the session's worker thread, pinned copies), forwards on the caller's
    # thread, and the worker with pageable copies
    runner = runner_mod.GRNetRunner(model, buckets=(450,))
    frames = rng.integers(0, 256, (900, 240, 320, 3), dtype=np.uint8)
    bb900, ci900 = np.concatenate([bbox, bbox]), np.concatenate([cimg, cimg])

    class CallerThread(runner_mod.ForwardStream):
        def _dispatch(self, m):
            rows = self._take_rows(m) if self.gait else {}
            self._outs.append(self._forward(self._take(m), rows))
            self._lengths.append(m)

    def pageable(x, device):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device)

    def stream(session_cls):
        crop_s = feed_s = 0.0
        t0 = time.perf_counter()
        session = session_cls(runner)
        for s in range(0, 900, 32):
            t = time.perf_counter()
            u8 = runner._host_crop(frames[s:s + 32], bb900[s:s + 32], 1.0)
            crop_s += time.perf_counter() - t
            t = time.perf_counter()
            session.feed(u8, bbox=bb900[s:s + 32], cimg=ci900[s:s + 32])
            feed_s += time.perf_counter() - t
        fed = time.perf_counter()
        session.finish()
        end = time.perf_counter()
        return {"crop_ms": crop_s * 1e3, "feed_ms": feed_s * 1e3,
                "finish_ms": (end - fed) * 1e3, "wall_ms": (end - t0) * 1e3}

    pinned = runner_mod.upload
    variants = {"port": runner_mod.ForwardStream, "caller_thread": CallerThread,
                "pageable": runner_mod.ForwardStream}
    for name in ("port", "caller_thread", "pageable", "pageable",
                 "caller_thread", "port"):
        runner_mod.upload = pageable if name == "pageable" else pinned
        try:
            stream(variants[name])
            row = stream(variants[name])
        finally:
            runner_mod.upload = pinned
        emit(study="forward_stream", frames=900, feed=32, variant=name,
             **row)


def launch_queue() -> None:
    """How many launches the host can queue ahead of the card, and when a
    forward returns to the host: each call starts behind a sleep kernel of
    about 200 ms, and the host time of the call is read beside the time
    left until the card is idle."""
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import card_line
    from gaitlab_torch.nn.grnet import GRNet

    card, cycles = card_line(), 400_000_000

    def host_ms(fn):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    x = torch.zeros(1, device="cuda")
    x.add_(1)
    for n in (500, 900, 1000, 1100, 1500, 3000):
        t, rest = host_ms(lambda: [x.add_(1) for _ in range(n)])
        print(json.dumps({"card": card, "study": "launch_queue", "launches": n,
                          "host_ms": t, "then_idle_ms": rest}), flush=True)
    crops = torch.randn(450, 224, 224, 3, device="cuda")
    rows = {"bbox": torch.tensor([[160.0, 120.0, 120.0, 120.0]] * 450,
                                 device="cuda"),
            "cimg": torch.tensor([[160.0, 120.0]] * 450, device="cuda")}
    for gait in (False, True):
        model = GRNet.create(seed=0, use_gait_feat=gait)
        kw = {"bbox": rows["bbox"], "cimg": rows["cimg"],
              "n_valid": 450} if gait else {}
        model.forward(crops, **kw)
        for _ in range(2):
            t, rest = host_ms(lambda: model.forward(crops, **kw))
            print(json.dumps({"card": card, "study": "forward_returns",
                              "model": "MAX-GRNet" if gait else "GRNet",
                              "bucket": 450, "host_ms": t,
                              "then_idle_ms": rest}), flush=True)
        del model


def serve_study() -> None:
    """Where a pinned program's load time and its time over the live
    model go (see the module's note)."""
    import tempfile

    import numpy as np
    import torch
    from torch.export._unlift import _check_input_constraints_pre_hook

    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, events_ms
    from gaitlab_torch import serve
    from gaitlab_torch.device import upload
    from gaitlab_torch.nn.grnet import GRNet
    from gaitlab_torch.pipeline.crop import normalize_image
    from gaitlab_torch.pipeline.runner import GRNetRunner

    card = card_line()
    model = GRNet.create(seed=0)
    with tempfile.TemporaryDirectory() as art:
        t0 = time.perf_counter()
        serve.save_artifacts(GRNetRunner(model, buckets=(B,)), art,
                             platforms=("cuda",))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ep = torch.export.load(osp.join(art, f"forward_b{B}.cuda.pt2"))
        t1 = time.perf_counter()
        ep.module()
        t2 = time.perf_counter()
        state, smpl = serve.load_weights(art)
        t3 = time.perf_counter()
        state = {k: upload(v, "cuda") for k, v in state.items()}
        smpl = smpl.to("cuda")
        torch.cuda.synchronize()
        print(json.dumps({
            "card": card, "study": "serve_load", "bucket": B,
            "export_s": export_s, "graph_nodes": len(ep.graph.nodes),
            "state_tensors": len(state), "export_load_s": t1 - t0,
            "module_s": t2 - t1, "load_weights_s": t3 - t2,
            "upload_s": time.perf_counter() - t3}), flush=True)
        sm = serve.load_artifacts(art)
    (prog,) = sm._programs[B]  # float32: one program a bucket
    x = upload(np.random.default_rng(0).integers(
        0, 255, (B, 224, 224, 3)).astype(np.uint8), "cuda")
    args = (sm.variables, sm.smpl._replace(faces=None), x)
    for _ in range(3):
        _check_input_constraints_pre_hook(prog, args, {})
    t0 = time.perf_counter()
    for _ in range(20):
        _check_input_constraints_pre_hook(prog, args, {})
    checks_ms = (time.perf_counter() - t0) / 20 * 1e3

    def pinned():
        sm._run(B, sm.variables, sm.smpl, x)

    for _ in range(2):
        row = {"card": card, "study": "serve_pinned", "bucket": B,
               "input_checks_host_ms": checks_ms,
               "pinned_ms": events_ms(pinned, reps=20)}
        prog.validate_inputs = False
        row["pinned_unchecked_ms"] = events_ms(pinned, reps=20)
        prog.validate_inputs = True
        row["live_ms"] = events_ms(lambda: model.forward(normalize_image(x)),
                                   reps=20)
        print(json.dumps(row), flush=True)


def dp_study() -> None:
    import statistics

    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import card_line
    from gaitlab_torch import training
    from gaitlab_torch.device import float32_math
    from gaitlab_torch.nn.grnet import GRNet, vp_regress
    from gaitlab_torch.parallel.replicas import Replicas, gather, scatter

    card = card_line()
    model = GRNet.create(seed=0)
    core, smpl = model.module, model.smpl
    reps = Replicas(core, [torch.device("cuda", 0)] * 2)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def forward(module, x):
        return vp_regress(smpl, module(x))[0]

    def host_ms(fn, reps_n=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps_n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def ways(x):
        parts = scatter(x, reps.devices)
        return {
            "one device": lambda: forward(core, x),
            "threads": lambda: gather(reps.apply(
                forward, [(p,) for p in parts]), reps.devices[0], dim=1),
            "one thread": lambda: gather(
                [forward(m, p) for m, p in zip(reps.modules, parts)],
                reps.devices[0], dim=1)}

    with float32_math():
        for rows in (32, 256):
            x = torch.randn(rows, 3, 224, 224, device="cuda", generator=gen)
            with torch.inference_mode():
                ms = {k: host_ms(f) for k, f in ways(x).items()}
            print(json.dumps({"card": card, "what": "forward", "rows": rows,
                              "replicas": 2, "host_ms": ms}), flush=True)
        rows = 32
        x = torch.randn(rows, 3, 224, 224, device="cuda", generator=gen)
        batch = training.synthetic_batch(rows, device="cuda")
        ms = {}
        for k, f in ways(x).items():
            ms[k] = host_ms(lambda f=f: training.grnet_loss(
                f(), batch)[0].backward())
        print(json.dumps({"card": card, "what": "train forward + backward",
                          "rows": rows, "replicas": 2, "host_ms": ms}),
              flush=True)


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
    elif cmd == "ablate_bf16":
        ablate_bf16()
    elif cmd == "gait":
        gait()
    elif cmd == "queue":
        launch_queue()
    elif cmd == "serve":
        serve_study()
    elif cmd == "dp":
        dp_study()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
