"""gaitlab_torch.cli.train on the CPU: shards, steps, checkpoints, resume,
the gait trainer, and the flags that raise.

The full-width model is replaced by test_torch_models' TINY trunk through
a monkeypatched GRNet.create (the CLI builds its model by name). Checks
are exact: step counts, files, log lines, which tensors moved and which
stayed bit-equal; the batch stream is compared with gaitlab's (same
indices, images normalized within 1e-6).
"""

import logging
import os.path as osp

import numpy as np
import pytest
import torch

from gaitlab.cli import train as jax_train
from gaitlab_torch.cli import train
from gaitlab_torch.nn.grnet import GRNet as PtGRNet
from test_torch_models import TINY
from test_train_cli import _make_shards
from torch_threads import torch_threads  # noqa: F401

# the head parameter whose exact gradient is 0 (a shift of all of one
# part's logits leaves its softmax unchanged): it moves on rounding noise
# or not at all
NOISE_ONLY = "head.keypoint_final_layer.bias"


@pytest.fixture
def tiny(monkeypatch):
    create = PtGRNet.create

    def small(*args, **kw):
        return create(*args, **{**kw, **TINY})

    monkeypatch.setattr(PtGRNet, "create", staticmethod(small))


def run(argv, caplog):
    with caplog.at_level(logging.INFO):
        return train.main(train.build_parser().parse_args(argv),
                          device="cpu")


def messages(caplog) -> list:
    return [r.getMessage() for r in caplog.records]


def test_parser_has_gaitlabs_flags():
    ours, theirs = train.build_parser(), jax_train.build_parser()
    assert ({a.dest: a.default for a in ours._actions}
            == {a.dest: a.default for a in theirs._actions})


def test_batch_stream_matches_gaitlab(tmp_path):
    _make_shards(tmp_path)
    pattern = str(tmp_path / "shard*.npz")
    data = train._load_shards(pattern)
    want = list(jax_train._batches(jax_train._load_shards(pattern), 3, 2, 7))
    got = list(train._batches(data, 3, 2, 7))
    for g, w in zip(got, want):
        for k in train.SHARD_KEYS[1:]:
            np.testing.assert_array_equal(g[k], w[k])
        x = train._to_device(g, "cpu")["images"]
        assert x.shape == (3, 3, 64, 64)
        np.testing.assert_allclose(x.permute(0, 2, 3, 1).numpy(),
                                   w["images"], rtol=1e-6, atol=1e-6)


def test_train_steps_checkpoint_and_resume(tmp_path, tiny, caplog):
    _make_shards(tmp_path)
    init = PtGRNet.create(device="cpu", seed=5)
    ckpt0 = str(tmp_path / "init.pth")
    torch.save({"gen_state_dict": init.module.state_dict()}, ckpt0)
    workdir = str(tmp_path / "run")
    common = ["--data", str(tmp_path / "shard*.npz"), "--workdir", workdir,
              "--batch_size", "2", "--lr", "1e-4", "--init_ckpt", ckpt0]
    model, state = run(common + ["--steps", "4", "--save_every", "2",
                                 "--log_every", "2"], caplog)
    assert state.step == 4 and osp.isfile(osp.join(workdir, "ckpt.pt"))
    logs = messages(caplog)
    assert "16 samples loaded" in logs
    assert [m.split(" (")[0].split(":")[0] for m in logs
            if m.startswith("step ")] == ["step 2", "step 4"]
    assert [m for m in logs if "checkpoint" in m] == [
        "checkpoint saved at step 2", "checkpoint saved at step 4"]
    start = init.module.state_dict()
    for k, v in model.module.state_dict().items():
        if k.startswith("backbone.") or "running" in k or "num_batches" in k:
            assert torch.equal(v, start[k]), k  # frozen, and BN buffers
        elif k.startswith("head.") and k != NOISE_ONLY:
            assert not torch.equal(v, start[k]), k

    caplog.clear()
    model2, state2 = run(common + ["--steps", "6", "--save_every", "100",
                                   "--resume"], caplog)
    assert "resumed from step 4" in messages(caplog)
    assert state2.step == 6
    assert state2.optimizer.state_dict()["state"][0]["step"] == 6
    saved = torch.load(osp.join(workdir, "ckpt.pt"), weights_only=True)
    assert saved["step"] == 6  # the last step is saved
    for k, v in model2.module.state_dict().items():
        assert torch.equal(saved["module"][k], v), k


def test_gait_trainer_on_shards(tmp_path, caplog):
    from gaitlab import training as jax_training

    batch = jax_training.synthetic_gait_batch(2, t=8, j=4, c=8, seed=0)
    np.savez(str(tmp_path / "gait0.npz"),
             **{k: np.asarray(v) for k, v in batch.items()})
    workdir = str(tmp_path / "run")
    module, state = run(["--data", str(tmp_path / "gait*.npz"), "--workdir",
                         workdir, "--gait", "--gait_h_size", "16", "--steps",
                         "3", "--save_every", "3", "--log_every", "1",
                         "--lr", "1e-3"], caplog)
    assert state.step == 3 and not module.stop_gaitfeat_grad
    assert osp.isfile(osp.join(workdir, "ckpt_gait.pt"))
    losses = [m for m in messages(caplog) if m.startswith("step ")]
    assert len(losses) == 3 and all("gait loss" in m and "steps/s" in m
                                    for m in losses)
    assert "gait checkpoint saved at step 3" in messages(caplog)


def test_gait_trainer_synthetic_trunk(tmp_path, tiny, caplog):
    module, state = run(["--data", "synthetic", "--workdir",
                         str(tmp_path / "run"), "--gait", "--gait_clips",
                         "2", "--gait_seq_len", "6", "--gait_h_size", "16",
                         "--steps", "2", "--log_every", "1"], caplog)
    assert state.step == 2
    losses = [float(m.split("loss ")[1].split(" ")[0])
              for m in messages(caplog) if m.startswith("step ")]
    assert len(losses) == 2 and np.all(np.isfinite(losses))


def test_use_mesh_raises(tmp_path, tiny, monkeypatch):
    """--use_mesh splits each batch evenly over the devices: a batch of 3
    over 2 raises, as gaitlab's sharded step refuses it."""
    _make_shards(tmp_path)
    monkeypatch.setattr(train, "mesh_devices",
                        lambda device: [torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="split evenly"):
        train.main_cli(["--data", str(tmp_path / "shard*.npz"), "--workdir",
                        str(tmp_path / "run"), "--use_mesh", "--steps", "1",
                        "--batch_size", "3"], device="cpu")


def test_use_mesh_trains_data_parallel(tmp_path, tiny, caplog, monkeypatch):
    """--use_mesh on the CPU is one device and takes the plain step; over
    a device list that names the CPU twice it takes the data-parallel
    step, whose losses agree with the plain step's within rtol 1e-5 and
    whose trained head within 0.1 x lr (the CLI's Adam turns a gradient's
    rounding noise into a step of up to lr; test_torch_parallel_train.py
    holds the step under SGD), and whose checkpoint has the same keys."""
    _make_shards(tmp_path)
    common = ["--data", str(tmp_path / "shard*.npz"), "--steps", "2",
              "--batch_size", "4", "--log_every", "1", "--use_mesh"]
    runs = {}
    for name, devices in (("plain", [torch.device("cpu")]),
                          ("dp", [torch.device("cpu")] * 2)):
        monkeypatch.setattr(train, "mesh_devices", lambda device: devices)
        caplog.clear()
        runs[name] = run(common + ["--workdir", str(tmp_path / name)], caplog)
        runs[name] += ([m for m in messages(caplog)
                        if m.startswith(("step ", "--use_mesh"))],)
    (plain, _, plain_log), (dp, dp_state, dp_log) = runs["plain"], runs["dp"]
    assert plain_log[0] == "--use_mesh: one device, the plain step"
    assert dp_log[0] == "--use_mesh: data parallel over 2 devices"
    loss = [[float(m.split("loss ")[1].split(" ")[0]) for m in log[1:]]
            for log in (plain_log, dp_log)]
    np.testing.assert_allclose(loss[1], loss[0], rtol=1e-5)
    lr = train.build_parser().get_default("lr")
    want = plain.module.state_dict()
    trained = dict(dp.module.named_parameters())
    for k, v in dp.module.state_dict().items():
        if k == NOISE_ONLY:
            continue
        if k.startswith("head.") and k in trained:
            assert (v - want[k]).abs().max() <= 0.1 * lr, k
        else:  # the frozen backbone and every BN buffer
            assert torch.equal(v, want[k]), k
    saved = torch.load(osp.join(tmp_path, "dp", "ckpt.pt"), weights_only=True)
    assert set(saved["module"]) == set(want) and dp_state.step == 2


def test_train_needs_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    _make_shards(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main_cli(["--data", str(tmp_path / "shard*.npz"), "--workdir",
                        str(tmp_path / "run"), "--steps", "1"])
