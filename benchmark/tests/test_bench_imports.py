"""What the benchmark loads: no module of JAX, Flax or the JAX package
(top-level names compared whole: gaitlab_torch is not gaitlab), and
nothing of the program in the reference."""

import json
import os.path as osp
import subprocess
import sys

from benchmark.harness import spec

BLOCK = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
"""


def loaded_tops(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", BLOCK + code + """
import json
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""], cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_nor_gaitlab():
    tops = loaded_tops("""
import importlib, pkgutil
import benchmark
from benchmark.harness import spec, runner, system, trace, check, inputs
from benchmark.harness import window
from benchmark.counts import flops, peaks, smpl
from benchmark.arch import grnet
import benchmark.run
for m in spec.manifest()["per_layer"]:
    spec.reader(m["name"])
import gaitlab_torch.nn.grnet, gaitlab_torch.pipeline.runner
""")
    assert not tops & {"jax", "jaxlib", "flax", "gaitlab"}, tops
    assert "gaitlab_torch" in tops


def test_reference_loads_nothing_of_the_program():
    tops = loaded_tops("""
from benchmark.reference import model, smpl, crop, track
""")
    assert not tops & {"jax", "jaxlib", "flax", "gaitlab", "gaitlab_torch"}


def test_forbidden_modules_compares_whole_names():
    from benchmark import run

    sys.modules.setdefault("gaitlab_torch_fake_probe", object())
    try:
        assert "gaitlab" not in run.forbidden_modules() or \
            "gaitlab" in {m.split(".")[0] for m in sys.modules}
    finally:
        del sys.modules["gaitlab_torch_fake_probe"]


def test_no_card_exits_without_a_result():
    """On a machine without CUDA the run exits non-zero and prints no
    result line (this sandbox has no card)."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, osp.join("benchmark", "run.py"), "--workload",
         "grnet_w32.clinic_tracks", "--seed", "5000000000", "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
