"""A torch.profiler trace of the GRNet step by stage, and its MFU report,
on one NVIDIA card.

The port's counterpart of scripts/mfu_trace.py (which stays as it is).
For each mode it runs the model step (GRNet at full width: HRNet-W32,
the PARE head with kernel B1, SMPL with kernel B2; random weights from
SEED, synthetic SMPL, noise crops) at --batch rows: one pass that counts
each stage's work, two warm-up steps, the step's device ms from CUDA
events without the profiler, then --iters chained steps under
torch.profiler (CPU and CUDA) inside one `mfu/window` range that ends
after a synchronize. It exports the Chrome trace and a sidecar of counts
to --trace_dir, then scripts/torch_mfu_report.py's report of both goes
into --out.

Stages are gaitlab's (mfu_report.py stage_of): stem, layer1, transition,
stages2-4, hr-head (the upsampling head), pare-head and smpl. The port
has no Flax op paths to read them from, so this script (not the
package) puts forward pre-hooks on each stage's first modules that leave
the open `record_function("stage/<name>")` range and enter the next:
a range runs from its stage's first module to the next stage's, so the
glue between modules (ReLUs, adds, the concatenation) stays in it; the
head's post-hook enters "smpl", which the step closes when the forward
returns. The same hooks count each stage's work from shapes, in the
counting pass only:
  * FLOPs: 2 per multiply-add of every Conv2d, ConvTranspose2d, Linear
    and locally connected layer; B1's and B2's analytic counts (as
    chip_smoke.py's bounds count them); SMPL's own products around B2
    (the joint regressor through the shape blendshapes, skinning, the
    vertex transform, the extra joints);
  * bytes: each of those layers' input read once, output written once,
    and its weights; the kernels' inputs and outputs. Elementwise layers
    (BatchNorm, ReLU, adds, the bilinear resize) are taken as fused and
    count no bytes.
Each stage's peak is that of its precision segment (report.peak_for):
FP32 at "float32", TF32 at "high", "default", w2x and a2x, bf16 on a
bf16 trunk; SMPL always FP32.

    python3 scripts/torch_mfu_trace.py                    # float32,high
    python3 scripts/torch_mfu_trace.py --modes high --batch 32 --iters 2

If the trace holds no device time (the profiler saw no kernel, as on the
CPU with --device cpu, which writes the trace and the counts), it says
so and exits 1 without writing a report. Writes docs/TORCH_MFU_TRACE.json
(or --out) with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import os.path as osp
import sys
import time

from torch_latency_bench import images
from torch_mfu_report import NoDeviceTime, peak_for, report
from torch_precision_study import REPO, at_mode
from torch_stage_timing import SEED, card, events_ms

BATCH = 128
ITERS = 8
MODES = ("float32", "high")
OUT = osp.join(REPO, "docs", "TORCH_MFU_TRACE.json")
TRACE_DIR = osp.join(REPO, "build", "torch_mfu_trace")
SMPL_JOINTS = 24
EXTRA_JOINTS = 29  # spin2's joint set, projected to 2D
HEADS = ("upsample_stage_2", "upsample_stage_3", "upsample_stage_4",
         "downsample_stage_1", "downsample_stage_2", "downsample_stage_3")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def b1_work(features, cam_feats, heatmaps) -> tuple[float, float]:
    """(FLOPs, bytes) of B1 on (B,H,W,C1), (B,H,W,C2), (B,H,W,J) inputs:
    the softmax over H*W and the pooling of both feature maps; each input
    read once, the (B,J,C1) and (B,J,C2) float32 outputs written once."""
    b, h, w, c1 = features.shape
    c2, j = cam_feats.shape[-1], heatmaps.shape[-1]
    flops = b * j * h * w * (2 * (c1 + c2) + 5)
    return flops, nbytes(features, cam_feats, heatmaps) + 4 * b * j * (c1 + c2)


def b2_work(v_template, shapedirs, posedirs, betas, pose_feature
            ) -> tuple[float, float]:
    """(FLOPs, bytes) of B2: v_template + shapedirs.betas +
    posedirs^T.pose_feature over R = 3V rows; inputs read once, the
    (B,V,3) float32 output written once."""
    b, r = betas.shape[0], v_template.numel()
    k = betas.shape[1] + pose_feature.shape[1]
    flops = 2 * b * r * k + b * r
    return flops, nbytes(v_template, shapedirs, posedirs, betas,
                         pose_feature) + 4 * b * r


def smpl_products(v_template, shapedirs, betas) -> float:
    """FLOPs of SMPL's products around B2 for B rows (body/smpl.py lbs and
    smpl_head): the joint regressor on the template and through the shape
    blendshapes, skinning's W.A and the per-vertex transform, and the
    extra joints' regressor and projection."""
    v, s = v_template.shape[0], shapedirs.shape[-1]
    b, j = betas.shape[0], SMPL_JOINTS
    return (2 * j * v * 3 * (1 + s) + 2 * b * v * (j * 16 + 9 + 3)
            + 2 * b * EXTRA_JOINTS * 9)


def counted_layers() -> tuple:
    """The layer types whose products the hooks count."""
    import torch.nn as nn

    from gaitlab_torch.nn.layers import LocallyConnected, LocallyConnected2d

    return (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, LocallyConnected2d,
            LocallyConnected)


def layer_flops(mod, x, out) -> float:
    """2 per multiply-add of one of counted_layers() on input x giving
    out."""
    import torch.nn as nn

    from gaitlab_torch.nn.layers import LocallyConnected2d

    if isinstance(mod, nn.Conv2d):
        kh, kw = mod.kernel_size
        return 2 * out.numel() * mod.in_channels // mod.groups * kh * kw
    if isinstance(mod, nn.ConvTranspose2d):
        kh, kw = mod.kernel_size
        return 2 * x.numel() * mod.out_channels // mod.groups * kh * kw
    if isinstance(mod, nn.Linear):
        return 2 * out.numel() * mod.in_features
    if isinstance(mod, LocallyConnected2d):  # weight (1, O, I, J, 1, 1)
        return 2 * out.numel() * mod.weight.shape[2]
    return 2 * out.numel() * mod.weight.shape[1]  # weight (J, I, O)


class StageHooks:
    """Stage ranges and counts on a GRNetCore (module docstring). `switch`
    leaves the open range and enters the named one (None: none); with
    `counting` set, the layers' and kernels' work is added to the open
    stage's counts ("other" outside every stage). `remove` takes every
    hook off again."""

    def __init__(self, core):
        import torch

        self.current, self._range, self.counting = None, None, False
        self.counts = collections.defaultdict(
            lambda: {"flops": 0.0, "bytes": 0.0, "kernel_flops": 0.0})
        self._record = torch.profiler.record_function
        bb = core.backbone
        markers = [(bb.conv1, "stem"), (bb.layer1, "layer1")]
        for t in (bb.transition1, bb.transition2, bb.transition3):
            markers += [(m, "transition") for m in t if m is not None]
        for s in (bb.stage2, bb.stage3, bb.stage4):
            markers += [(m, "stages2-4") for m in s]
        markers += [(getattr(bb, n), "hr-head") for n in HEADS
                    if hasattr(bb, n)]
        markers.append((core.head, "pare-head"))
        self._handles = [m.register_forward_pre_hook(
            lambda mod, args, stage=stage: self.switch(stage))
            for m, stage in markers]
        self._handles.append(core.head.register_forward_hook(
            lambda mod, args, out: self.switch("smpl")))
        self._handles += [m.register_forward_hook(self._count_layer)
                          for m in core.modules()
                          if isinstance(m, counted_layers())]

    def switch(self, stage) -> None:
        if stage == self.current:
            return
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.current = stage
        if stage is not None:
            self._range = self._record(f"stage/{stage}")
            self._range.__enter__()

    def add(self, flops: float, nbytes_: float, kernel: bool = False) -> None:
        if self.counting:
            c = self.counts[self.current or "other"]
            c["flops"] += flops
            c["bytes"] += nbytes_
            if kernel:
                c["kernel_flops"] += flops

    def _count_layer(self, mod, args, out) -> None:
        if self.counting:
            x = args[0]
            self.add(layer_flops(mod, x, out),
                     nbytes(x, out, *mod.parameters(recurse=False)))

    @contextlib.contextmanager
    def kernels_counted(self):
        """B1 and B2 counted at their call sites (nn/pare_head.py,
        body/smpl.py), SMPL's own products with B2's call."""
        from gaitlab_torch.body import smpl
        from gaitlab_torch.nn import pare_head

        b1, b2 = pare_head.keypoint_attention_fused, smpl.blendshapes

        def b1_spy(*args):
            self.add(*b1_work(*args), kernel=True)
            return b1(*args)

        def b2_spy(*args):
            self.add(*b2_work(*args), kernel=True)
            self.add(smpl_products(args[0], args[1], args[3]), 0.0)
            return b2(*args)

        pare_head.keypoint_attention_fused, smpl.blendshapes = b1_spy, b2_spy
        self.counting = True
        try:
            yield
        finally:
            self.counting = False
            pare_head.keypoint_attention_fused, smpl.blendshapes = b1, b2

    def remove(self) -> None:
        self.switch(None)
        for h in self._handles:
            h.remove()


def stage_peaks(core) -> dict:
    """{stage: (modes, FLOP/s peak)} from the trunk's precision segments:
    a stage over several regions takes the fastest of their peaks."""
    bb = core.backbone
    dtype = str(bb.conv1.weight.dtype).replace("torch.", "")
    regions = {"stem": ("stem",), "layer1": ("layer1",),
               "transition": ("stage2", "stage3", "stage4"),
               "stages2-4": ("stage2", "stage3", "stage4"),
               "hr-head": ("heads",)}
    out = {s: sorted({bb.region_mode(r) for r in rs})
           for s, rs in regions.items()}
    out["pare-head"] = [core.head.precision]
    peaks = {s: (m, max(peak_for(x, dtype) for x in m))
             for s, m in out.items()}
    peaks["smpl"] = (["float32"], peak_for("float32"))
    return peaks


def trace_mode(model, mode: str, batch: int, iters: int, trace_dir: str,
               on_card: bool, card_line) -> tuple[str, dict, dict]:
    """Count, warm up, time and trace `mode`; returns (trace path,
    sidecar, the step's device ms from CUDA events or None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    run = at_mode(model, mode)
    x = images(batch, model.device)
    hooks = StageHooks(run.module)
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def step():
        out = run.forward(x)
        hooks.switch(None)
        return out

    try:
        with hooks.kernels_counted():
            step()
        for _ in range(2):
            step()
        sync()
        step_ms = events_ms(step) if on_card else None
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        t0 = time.perf_counter()
        with profile(activities=activities) as prof:
            with record_function("mfu/window"):
                for _ in range(iters):
                    step()
                sync()
        wall_s = time.perf_counter() - t0
    finally:
        hooks.remove()
    os.makedirs(trace_dir, exist_ok=True)
    path = osp.join(trace_dir, f"{mode}.json")
    prof.export_chrome_trace(path)
    peaks = stage_peaks(run.module)
    stages = {}
    for name, c in hooks.counts.items():
        modes, peak = peaks.get(name, (["float32"], peak_for("float32")))
        stages[name] = {**c, "modes": modes, "peak_flop_per_s": peak}
    sidecar = {"script": "scripts/torch_mfu_trace.py", "mode": mode,
               "batch": batch, "iters": iters, "card": card_line,
               "profiled_wall_s": wall_s,
               "bytes_counted": "each Conv2d/ConvTranspose2d/Linear/locally "
                                "connected layer's input read once, output "
                                "written once, and its weights; B1's and "
                                "B2's inputs and outputs; elementwise "
                                "layers taken as fused (no bytes)",
               "stages": stages}
    with open(osp.join(trace_dir, f"{mode}.counts.json"), "w") as f:
        json.dump(sidecar, f, indent=1)
    del run
    return path, sidecar, step_ms


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--trace_dir", default=TRACE_DIR)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (raises without CUDA)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    from gaitlab_torch.device import resolve_device
    from gaitlab_torch.nn.grnet import GRNet

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    card_line = card() if on_card else None
    model = GRNet.create(seed=SEED, device=dev)
    res = {"script": "scripts/torch_mfu_trace.py", "card": card_line,
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "torch": torch.__version__, "batch": args.batch,
           "iters": args.iters, "modes": {}}
    for mode in args.modes.split(","):
        path, sidecar, step_ms = trace_mode(model, mode, args.batch,
                                            args.iters, args.trace_dir,
                                            on_card, card_line)
        with open(path) as f:
            trace = json.load(f)
        try:
            rep = report(trace, sidecar)
        except NoDeviceTime as e:
            log(f"[mfu_trace] {mode}: {e} (trace and counts in "
                f"{args.trace_dir}); no report written")
            return 1
        rep["events_ms_per_iter"] = step_ms
        res["modes"][mode] = rep
        log(f"[mfu_trace] {mode}: {rep['total_device_ms_per_iter']:.3f} "
            f"device ms/iter (CUDA events without the profiler "
            f"{step_ms:.3f}), busy {rep['busy_pct']:.1f}%, mfu "
            f"{rep['mfu_pct']:.2f}%; " + ", ".join(
                f"{k} {v['share_pct']:.1f}%" for k, v in
                rep["stages"].items()))
    os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
        f.write("\n")
    log(f"[mfu_trace] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
