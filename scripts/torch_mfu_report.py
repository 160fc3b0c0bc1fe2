"""Stage and MFU report from a torch.profiler trace of the GRNet step.

The port's counterpart of scripts/mfu_report.py (which stays as it is).
It reads the Chrome trace that scripts/torch_mfu_trace.py exports and
its sidecar of counts, and needs no card. Every device event (kernel,
memcpy, memset) is attributed to the stage whose range (a
`record_function("stage/<name>")` span on the host) held the host call
that launched it: the event's correlation id (`args.correlation`) names
its launch on the host (a CUDA runtime or driver call with the same id,
or the start of its `ac2g` flow), and the range around that call's
start is the stage. Launches outside every range count as "other".

Per stage: device ms per iteration, the share of device time, the FLOP
rate, `mfu_pct` against the card's published dense peak for the stage's
precision, and the bound that limits it: the larger of the stage's
FLOPs over that peak and its bytes over the HBM rate (`bound_by`
"flops" or "bytes"), with the stage's time as a share of that bound.
Overall: `total_device_ms_per_iter`, `busy_pct` (the union of device
events over the host window that held the traced iterations and ended
after a synchronize) and `mfu_pct` = sum over stages of FLOPs / peak,
over the device time; then the top kernels by time, and the port's own
kernels (B1, B2) by name.

FLOPs are nominal, one multiply-add = 2 FLOPs, as the sidecar counts
them: a "high" product runs as three TF32 passes and a w2x one as two,
and those passes are not counted, so "high" is held to the TF32 peak for
the FLOPs the model asks for.

    python3 scripts/torch_mfu_report.py TRACE.json SIDECAR.json [--out
        OUT.json]

Raises NoDeviceTime (exit 1) when the trace holds no device time: the
profiler saw no kernel, and no report is written.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import gzip
import json
import sys

# NVIDIA H100 SXM, dense, at its full 700 W power limit (NVIDIA's data
# sheet; a card set below it runs slower under load)
H100_BYTES_PER_S = 3.35e12     # HBM3
H100_FP32_FLOP_PER_S = 67e12   # FP32 outside the tensor cores
H100_TF32_FLOP_PER_S = 495e12  # TF32 tensor cores
H100_BF16_FLOP_PER_S = 989e12  # bf16 tensor cores
# the stage order of gaitlab's report (mfu_report.py stage_of)
STAGES = ("stem", "layer1", "transition", "stages2-4", "hr-head",
          "pare-head", "smpl")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP_N = 15  # kernels listed by time
# the port's kernels as the profiler names them: B1 (FP32 inputs: split
# and merge; bf16 inputs) and B2
PORT_KERNELS = {"attention_split_kernel": "B1", "attention_merge_kernel": "B1",
                "attention_bf16_kernel": "B1 (bf16)",
                "blendshapes_kernel": "B2"}


class NoDeviceTime(RuntimeError):
    """The trace holds no device event: the profiler saw no kernel."""


def peak_for(mode: str, dtype: str = "float32") -> float:
    """The card's dense FLOP/s for a segment at precision `mode` whose
    operands are `dtype`: bf16 tensor cores for a bf16 trunk, TF32 ones
    for the TF32 modes ("high", "default", w2x, a2x), FP32 otherwise."""
    if dtype == "bfloat16":
        return H100_BF16_FLOP_PER_S
    return H100_FP32_FLOP_PER_S if mode == "float32" else H100_TF32_FLOP_PER_S


def load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _launches(events: list) -> dict:
    """{correlation id: (pid, tid, ts)} of each host launch."""
    out = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver") \
                and corr is not None:
            out[corr] = (e["pid"], e["tid"], e["ts"])
    for e in events:  # flows: where a runtime event was not kept
        if e.get("cat") == "ac2g" and e.get("ph") == "s" \
                and e["id"] not in out:
            out[e["id"]] = (e["pid"], e["tid"], e["ts"])
    return out


def _ranges(events: list) -> dict:
    """{(pid, tid): ([starts], [(start, end, stage)])} of the stage
    ranges, sorted by start."""
    by_thread = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e["name"].startswith("stage/"):
            by_thread[(e["pid"], e["tid"])].append(
                (e["ts"], e["ts"] + e["dur"], e["name"][len("stage/"):]))
    return {k: ([r[0] for r in sorted(v)], sorted(v))
            for k, v in by_thread.items()}


def _stage_at(ranges: dict, pid, tid, ts) -> str:
    starts, spans = ranges.get((pid, tid), ((), ()))
    i = bisect.bisect_right(starts, ts) - 1
    if i >= 0 and spans[i][0] <= ts <= spans[i][1]:
        return spans[i][2]
    return "other"


def _union_us(intervals: list) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def report(trace: dict, sidecar: dict, top_n: int = TOP_N) -> dict:
    """The report (module docstring) of a Chrome trace and its sidecar:
    {"iters", "stages": {stage: {"flops", "bytes", "peak_flop_per_s"}},
    "mode", "batch", ...}."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    iters = sidecar["iters"]
    launches, ranges = _launches(events), _ranges(events)
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not device or not sum(e["dur"] for e in device) > 0:
        raise NoDeviceTime("the trace holds no device time: the profiler "
                           "saw no kernel on the card, so there is no "
                           "report")
    windows = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "user_annotation"
               and e["name"] == "mfu/window"]
    per_stage = collections.defaultdict(float)
    kernels = collections.defaultdict(lambda: [0.0, 0, collections.Counter()])
    for e in device:
        launch = launches.get((e.get("args") or {}).get("correlation"))
        stage = _stage_at(ranges, *launch) if launch else "other"
        per_stage[stage] += e["dur"]
        k = kernels[e["name"]]
        k[0] += e["dur"]
        k[1] += 1
        k[2][stage] += e["dur"]
    total_us = sum(per_stage.values())

    def ms(us):
        return us / iters / 1e3

    stages, ideal_s, flops_all = {}, 0.0, 0.0
    for name in list(STAGES) + sorted(set(per_stage) - set(STAGES)):
        counts = sidecar["stages"].get(name, {})
        t = ms(per_stage.get(name, 0.0))
        flops = counts.get("flops", 0.0)
        nbytes = counts.get("bytes", 0.0)
        peak = counts.get("peak_flop_per_s", H100_FP32_FLOP_PER_S)
        flops_ms = flops / peak * 1e3
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        bound_ms = max(flops_ms, bytes_ms)
        ideal_s += flops / peak
        flops_all += flops
        stages[name] = {
            "ms_per_iter": t,
            "share_pct": 100.0 * per_stage.get(name, 0.0) / total_us,
            "flops_per_iter": flops, "bytes_per_iter": nbytes,
            "kernel_flops_per_iter": counts.get("kernel_flops", 0.0),
            "tflop_per_s": flops / (t * 1e-3) / 1e12 if t else None,
            "peak_tflop_per_s": peak / 1e12,
            "mfu_pct": 100.0 * flops / (t * 1e-3) / peak if t else None,
            "bound_by": "flops" if flops_ms >= bytes_ms else "bytes",
            "bound_ms": bound_ms,
            "pct_of_bound": 100.0 * bound_ms / t if t else None,
        }
    device_s = total_us / iters / 1e6
    window_us = windows[0]["dur"] if windows else None
    iv = [(e["ts"], e["ts"] + e["dur"]) for e in device]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])

    def row(name, k):
        return {"name": name[:120], "ms_per_iter": ms(k[0]),
                "share_pct": 100.0 * k[0] / total_us,
                "calls_per_iter": k[1] / iters,
                "stage": k[2].most_common(1)[0][0]}

    return {
        "mode": sidecar.get("mode"), "batch": sidecar.get("batch"),
        "iters": iters, "card": sidecar.get("card"),
        "flops_counted": "nominal: 2 per multiply-add of every Conv2d, "
                         "ConvTranspose2d, Linear and locally connected "
                         "layer, B1's and B2's analytic counts and SMPL's "
                         "products; the extra TF32 passes of 'high' (3 "
                         "per product) and w2x (2) are not counted",
        "bytes_counted": sidecar.get("bytes_counted"),
        "total_device_ms_per_iter": total_us / iters / 1e3,
        "window_ms_per_iter": window_us / iters / 1e3 if window_us else None,
        "busy_pct": 100.0 * _union_us(iv) / window_us if window_us else None,
        "tflop_per_s": flops_all / device_s / 1e12,
        "mfu_pct": 100.0 * ideal_s / device_s,
        "stages": stages,
        "top_kernels": [row(n, k) for n, k in top[:top_n]],
        "port_kernels": {n: {"kernel": label, **row(n, k)}
                         for n, k in top for sub, label in
                         PORT_KERNELS.items() if sub in n},
        "device_events_per_iter": len(device) / iters,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace")
    ap.add_argument("sidecar")
    ap.add_argument("--out", default=None, help="write the report here")
    args = ap.parse_args(argv)
    with open(args.sidecar) as f:
        sidecar = json.load(f)
    rep = report(load_trace(args.trace), sidecar)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
            f.write("\n")
    print(json.dumps({k: rep[k] for k in (
        "mode", "total_device_ms_per_iter", "busy_pct", "mfu_pct")}))
    for name, s in rep["stages"].items():
        print(f"{name:10s} {s['ms_per_iter']:9.3f} ms {s['share_pct']:6.2f}%"
              f"  mfu {s['mfu_pct'] or 0:6.2f}%  bound {s['bound_by']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
