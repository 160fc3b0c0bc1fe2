"""The runner's derived state and its modes across the paths that copy the
model: the data-parallel replicas and the pipeline follow a weight reload
and a reassignment made after the runner was built; the pipeline's stages
and a pinned serving program run the runner's precision.

All on the CPU with the shrunk trunk (test_torch_models.TINY) and
64-pixel crops; the device lists repeat the CPU, as in
test_torch_parallel*.py. Tolerances: a replica or a pipeline stage runs
the same ops on the same weights as the one-device runner, so they agree
to float32 rounding of sums taken in other batch splits (atol 1e-5 on
outputs of about 1); a loaded program against the live runner it was
exported from, 1e-5 (test_torch_serve.py).
"""

import inspect

import numpy as np
import pytest
import torch

from gaitlab.parallel.pipeline import GRNetPipeline as JaxPipeline
from gaitlab_torch import device as pt_device
from gaitlab_torch import serve
from gaitlab_torch.nn import layers as pt_layers
from gaitlab_torch.nn.grnet import GRNet as PtGRNet
from gaitlab_torch.parallel import mesh as pt_mesh
from gaitlab_torch.pipeline.runner import GRNetRunner as PtRunner
from test_torch_models import TINY, assert_close
from torch_threads import torch_threads  # noqa: F401

CPU = torch.device("cpu")
CROP = 64
PER_FRAME = ("theta", "verts", "kp_2d", "kp_3d")


@pytest.fixture
def crops():
    return torch.from_numpy(np.random.default_rng(2).normal(
        size=(8, CROP, CROP, 3)).astype(np.float32))


def _one_device(model, crops, **kw):
    return PtRunner(model, buckets=(8,), crop_size=CROP, **kw).forward_crops(
        crops)


def _agree(got, want, what):
    for k in PER_FRAME:
        assert_close(got[k], want[k], rtol=0, atol=1e-5, what=f"{what} {k}")


def test_dp_and_pp_follow_a_reload_and_a_reassignment(crops, monkeypatch):
    """Weights loaded in place after the runners were built reach every
    replica and the pipeline, and so do a reassigned module and SMPL."""
    model = PtGRNet.create(device="cpu", seed=4, **TINY)
    monkeypatch.setattr(pt_mesh, "devices_for", lambda device: [CPU, CPU])
    dp = PtRunner(model, buckets=(8,), crop_size=CROP,
                  mesh=pt_mesh.make_mesh(devices=[CPU, CPU]))
    pp = PtRunner(model, buckets=(8,), crop_size=CROP, parallel="pp")
    _agree(dp.forward_crops(crops), _one_device(model, crops), "dp")

    other = PtGRNet.create(device="cpu", seed=9, **TINY)
    model.module.load_state_dict(other.module.state_dict())  # in place
    want = _one_device(model, crops)
    _agree(dp.forward_crops(crops), want, "dp after a reload")
    _agree(pp.forward_crops(crops), want, "pp after a reload")

    third = PtGRNet.create(device="cpu", seed=11, **TINY)
    model.module, model.smpl = third.module, third.smpl._replace(
        v_template=third.smpl.v_template + 0.01)
    want = _one_device(model, crops)
    _agree(dp.forward_crops(crops), want, "dp after a reassignment")
    _agree(pp.forward_crops(crops), want, "pp after a reassignment")
    # replica 0 stays the module itself
    assert dp._dp[0].modules[0] is model.module


def test_a_bf16_trunk_follows_a_reload(crops):
    """The bf16 copy of the weights is made again for each weight version."""
    model = PtGRNet.create(device="cpu", seed=4, **TINY)
    runner = PtRunner(model, buckets=(8,), crop_size=CROP, precision="high",
                      trunk_dtype="bfloat16")
    first = runner.forward_crops(crops)
    assert next(runner._live()["core"].parameters()).dtype == torch.bfloat16
    other = PtGRNet.create(device="cpu", seed=9, **TINY)
    model.module.load_state_dict(other.module.state_dict())
    again = runner.forward_crops(crops)
    fresh = PtRunner(model, buckets=(8,), crop_size=CROP, precision="high",
                     trunk_dtype="bfloat16").forward_crops(crops)
    for k in PER_FRAME:
        np.testing.assert_array_equal(again[k], fresh[k])
    assert np.abs(again["kp_3d"] - first["kp_3d"]).max() > 1e-3


def test_pp_stages_run_the_runners_precision(crops, monkeypatch):
    """The port's pipeline runs the runner's mode in both stages (gaitlab
    builds its pipeline without it, so its pp path runs at the backend's
    default: a fault of the reference that the port does not copy)."""
    assert "precision" not in inspect.signature(JaxPipeline).parameters
    model = PtGRNet.create(device="cpu", seed=4, **TINY)
    monkeypatch.setattr(pt_mesh, "devices_for", lambda device: [CPU, CPU])
    seen = set()
    real = pt_layers.Conv2d.forward

    def conv(self, x):
        seen.add((pt_device.held_math_mode(), pt_layers._CONV_MODE.get()))
        return real(self, x)

    monkeypatch.setattr(pt_layers.Conv2d, "forward", conv)
    pp = PtRunner(model, buckets=(8,), crop_size=CROP, parallel="pp",
                  precision="high")
    got = pp.forward_crops(crops)
    assert seen == {(True, "high"), (True, "w2x"), (True, "default")}
    _agree(got, _one_device(model, crops, precision="high"), "pp at high")


def test_pinned_high_program_matches_the_live_runner(tmp_path, crops):
    """A "high" export is two programs a bucket (the trunk with TF32 on,
    SMPL with it off); loaded, it gives the live runner's outputs, and the
    serving runner reads the modes back from the manifest."""
    model = PtGRNet.create(device="cpu", seed=4, **TINY)
    runner = PtRunner(model, buckets=(4,), crop_size=CROP, precision="high")
    art = str(tmp_path / "art")
    man = serve.save_artifacts(runner, art, platforms=("cpu",))
    assert (man["precision"], man["head_precision"], man["trunk_dtype"],
            man["region_precision"], man["tf32"]) == (
                "high", "default", None, [["heads", "w2x"]], [True, False])
    assert man["files"] == {"4": {"cpu": ["forward_b4.0.cpu.pt2",
                                          "forward_b4.1.cpu.pt2"]}}
    u8 = np.random.default_rng(3).integers(0, 255, (3, CROP, CROP, 3),
                                           dtype=np.uint8)
    srunner = serve.load_runner(art, device="cpu")
    got = srunner.serving.call(None, None, u8)
    live = runner.forward_crops(torch.from_numpy(u8))
    for k in PER_FRAME:
        assert_close(got[k], live[k], rtol=1e-5, atol=1e-5, what=k)
    assert (srunner.precision, srunner.resolved_head_precision(),
            srunner.resolved_region_precision()) == (
                "high", "default", (("heads", "w2x"),))
