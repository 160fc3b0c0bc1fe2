"""On the card: the check's control (the program at precision "default",
one TF32 pass, in place of float32 with TF32 off) comes out not correct,
and the program itself correct, at each cell's own sizes with a short
window. Skipped without a card (decided inside the test)."""

import json
import os.path as osp
import subprocess
import sys

import pytest

from benchmark.harness import spec

CELLS = [w["name"] for w in spec.manifest()["workloads"]]


def run(cell, seed, control):
    cmd = [sys.executable, osp.join("benchmark", "run.py"), "--workload",
           cell, "--seed", str(seed), "--seconds", "5", "--trace", "0"]
    out = subprocess.run(cmd + (["--control"] if control else []),
                         cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert run(cell, 7000000001, control=False)["correct"]
    for seed in (7000000002, 7000000003, 7000000004):
        assert not run(cell, seed, control=True)["correct"]
