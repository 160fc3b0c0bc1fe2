"""Per-stage wall-clock telemetry for the CLI.

Counterpart of gaitlab/utils.py's StageTimer: one structured report of the
demo's stages in place of scattered time brackets.
"""

from __future__ import annotations

import contextlib
import time


class StageTimer:
    """Seconds spent per named stage, summed over repeats."""

    def __init__(self):
        self.stages: dict[str, float] = {}
        self._t0 = time.time()

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.time()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.time() - t

    def total(self) -> float:
        return time.time() - self._t0

    def report(self) -> str:
        lines = [f"  {k}: {v:.2f}s" for k, v in self.stages.items()]
        return "\n".join(lines + [f"  total: {self.total():.2f}s"])
