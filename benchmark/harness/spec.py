"""The manifest (BENCHMARK.json at the checkout's root) and the files it
names, each found by name: a configuration `configs/<config>.json`, the
module of the architecture that the configuration names
`arch/<arch>.py`, a traffic mix `traffic/<traffic>.json`, a per-layer
metric `metrics/<metric>.py`."""

from __future__ import annotations

import importlib
import json
import os.path as osp

BENCH_DIR = osp.dirname(osp.dirname(osp.abspath(__file__)))
ROOT = osp.dirname(BENCH_DIR)


def manifest(root: str = ROOT) -> dict:
    with open(osp.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(osp.join(BENCH_DIR, kind, f"{name}.json")) as f:
        return json.load(f)


def load_arch(config: str, cfg: dict):
    """The module `benchmark.arch.<arch>` of the architecture that the
    configuration `config` (its file's contents `cfg`) names under "arch".
    A configuration without one, or one whose module is missing, ends
    the run naming the file."""
    arch = cfg.get("arch")
    if not isinstance(arch, str) or not arch.isidentifier():
        raise SystemExit(f"benchmark/configs/{config}.json names no "
                         f"architecture: its \"arch\" is {arch!r}, not the "
                         "name of a module benchmark/arch/<arch>.py")
    module = f"benchmark.arch.{arch}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise SystemExit(f"benchmark/configs/{config}.json: architecture "
                         f"{arch!r} has no module benchmark/arch/{arch}.py"
                         ) from None


class Cell:
    """One entry of `workloads`, with its configuration, its
    architecture's module, its traffic and the metrics it reports."""

    def __init__(self, name: str, man: dict | None = None):
        man = manifest() if man is None else man
        cells = {w["name"]: w for w in man["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(have {sorted(cells)})")
        self.name = name
        self.entry = cells[name]
        self.cfg = load_json("configs", self.entry["config"])
        self.arch = load_arch(self.entry["config"], self.cfg)
        self.traffic = load_json("traffic", self.entry["traffic"])
        if self.traffic.get("loop") != "closed":
            raise SystemExit(f"traffic {self.entry['traffic']!r}: the "
                             "harness runs closed loops only")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in man["end_to_end"] if self.reports(m)]
        self.per_layer = [m for m in man["per_layer"] if self.reports(m)]

    def reports(self, metric: dict) -> bool:
        cells = metric.get("workloads")
        return cells is None or self.name in cells


def reader(metric: str):
    """The `read(ctx)` function of metrics/<metric>.py."""
    mod = importlib.import_module(f"benchmark.metrics.{metric}")
    return mod.read
