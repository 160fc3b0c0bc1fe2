"""One run of a cell: set-up, the window (traced or not), the metrics,
the check. What the cell's model is, how it is built and checked, comes
from its architecture's module (`cell.arch`, arch/<arch>.py). `Run`
takes its device as given, so that the tests can drive it on the CPU at
a tiny size; run.py alone decides that a run needs the card."""

from __future__ import annotations

import contextlib
import gc
import sys
import time

import torch

from benchmark.harness import check, inputs, spec, trace, window


class Ctx:
    """What a per-layer metric's reader gets: the configuration, the
    traced window (`trace`: a TraceView, or None without device time),
    the hooks' row counts, the window's tracks, the step's counts (the
    architecture's `counts`), and `log` for lines on standard error with
    the card beside them."""

    def __init__(self, cfg, tv, hooks, win, counts, card: str):
        self.cfg, self.trace, self.hooks, self.window = cfg, tv, hooks, win
        self.counts, self.card = counts, card
        self.precision = cfg["precision"]

    def log(self, line: str) -> None:
        print(f"{line} [{self.card}]", file=sys.stderr, flush=True)

    def forwards(self) -> list:
        """[(rows run, real frames)] per forward of the traced window: the
        rows as the trunk's pre-hook saw them, the real frames as the runner
        passed them to each bucket's forward. Counts that disagree with each
        other or with the window's tracks stop the run: a metric read from
        them would be wrong."""
        rows, real = self.hooks.rows, self.hooks.real
        if len(rows) != len(real) or sum(real) != sum(self.window.frames):
            raise RuntimeError(
                f"{len(rows)} trunk forwards against {len(real)} bucket "
                f"forwards, {sum(real)} real frames against "
                f"{sum(self.window.frames)} in the window's tracks")
        return list(zip(rows, real))

    def stage_s(self, *stages) -> float:
        return sum(self.trace.stage_s.get(s, 0.0) for s in stages)

    def kernel_s(self, *names) -> float:
        return sum(t for k, t in self.trace.kernel_s.items()
                   if any(n in k for n in names))


class Run:
    def __init__(self, cell, seed: int, device, precision=None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.traffic, self.arch = cell.cfg, cell.traffic, cell.arch
        self.precision = precision or self.cfg["precision"]
        self.on_card = self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        cfg, tr, dev, arch = self.cfg, self.traffic, self.device, self.arch
        run = cfg["runner"]
        t = time.perf_counter()
        self.pool = inputs.make_pool(self.seed, dev, tr["pool_frames"],
                                     tuple(tr["frame_hw"]))
        t = _lap("pool", t)
        chunk = run["ingest_chunk"]
        self.schedule = inputs.Schedule(tr, self.seed, self.pool, chunk)
        extra = inputs.Schedule(tr, self.seed + 1, self.pool, chunk)
        self.sd = inputs.make_weights(arch.skeleton(cfg), self.seed, dev,
                                      cfg.get("init", {}))
        s = cfg["smpl"]
        self.smpl = inputs.make_smpl(self.seed, dev, s["num_verts"],
                                     s["num_betas"])
        t = _lap("weights", t)
        cal = extra.extra(cfg["calibration_frames"])
        arch.calibrate(self.sd, cfg, cal.frames(), cal.boxes, dev)
        t = _lap("calibration", t)
        self.model, self.runner = arch.build(cfg, self.sd, self.smpl, dev,
                                             self.precision)
        t = _lap("build", t)
        window.warm_up(self.runner, extra.extra,
                       inputs.buckets_used(tr, run["buckets"]))
        self.sync()
        _lap("warm-up", t)

    def execute(self, seconds: float, traced: bool, t_start: float,
                card=lambda: "no card") -> dict:
        self.setup()
        keep = window.keep_set(self.seed, self.traffic["check_share"])
        top = max(self.cfg["runner"]["buckets"])
        if self.on_card:
            torch.cuda.reset_peak_memory_stats(self.device)
        res = {}
        if not traced:
            gc.collect()
            setup_s = time.time() - t_start
            win = window.run(self.runner, self.schedule, seconds, keep, top)
            self.sync()
            _lap(f"window ({win.attempted} tracks)", win.t0)
            values = {"frames_per_s": win.frames_per_s,
                      "setup_s": lambda: setup_s}
            res["metrics"] = {m["name"]: {"value": values[m["name"]](),
                                          "unit": m["unit"]}
                              for m in self.cell.end_to_end}
        else:
            counts = self.arch.counts(self.cfg, self.sd)
            hooks = trace.StageHooks(self.arch.trunk(self.runner), self.cfg)
            trace.instrument(self.runner, hooks)
            span = min(seconds, self.traffic["trace_seconds"])
            gc.collect()
            try:
                with trace.profiler(self.on_card) as prof:
                    with trace.window_span() if self.on_card \
                            else contextlib.nullcontext():
                        win = window.run(self.runner, self.schedule, span,
                                         keep, top)
            finally:
                hooks.remove()
            t = _lap(f"traced window ({win.attempted} tracks)", win.t0)
            events = trace.events_of(prof)
            tv = trace.TraceView(events) if self.on_card else None
            _lap(f"trace read ({len(events)} events)", t)
            del events
            ctx = Ctx(self.cfg, tv, hooks, win, counts, card())
            res["metrics"] = {}
            for m in self.cell.per_layer:
                v = spec.reader(m["name"])(ctx)
                if v is not None:
                    res["metrics"][m["name"]] = {"value": v,
                                                 "unit": m["unit"]}
            if tv is not None:
                res["device_extra"] = {"busy_s": tv.busy_s,
                                       "window_s": tv.window_s}
                res["breakdown"] = {
                    "device_ops": [[n, s] for n, s in tv.device_ops()[:10]],
                    "idle_gaps": [[n, s] for n, s in tv.idle_gaps()[:10]]}
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.on_card else 0)
        kept = win.kept
        # the program's state goes before the reference runs
        del self.runner, self.model
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        refs = check.reference_outputs(kept, self.schedule, self.sd,
                                       self.smpl, self.cfg, self.arch,
                                       self.device)
        _lap(f"reference ({sum(len(self.schedule[i]) for i in kept)} "
             "frames)", t)
        ok, table = check.judge(check.gaps(kept, refs), self.cfg["limits"])
        device = {"platform": "gpu" if self.on_card else "cpu",
                  "kind": (torch.cuda.get_device_name(self.device)
                           if self.on_card else "cpu"),
                  "count": self.cell.chips, "memory_peak_bytes": peak}
        device.update(res.pop("device_extra", {}))
        # a track that raises ends the run without a result: none fails
        # inside a finished window
        out = {"correct": ok, "attempted": win.attempted, "failed": 0,
               "metrics": res["metrics"], "device": device}
        if "breakdown" in res:
            out["breakdown"] = res["breakdown"]
        out["check"] = table
        return out


def _lap(what: str, t: float) -> float:
    now = time.perf_counter()
    print(f"[bench] {what} {now - t:.3f} s", file=sys.stderr, flush=True)
    return now
