"""The gait branch's serving artifacts (gaitlab_torch/serve.py with
MAX-GRNet) and the masked BiGRU (nn/gait.py) against the live port runner
and gaitlab.

A small MAX-GRNet (tests/test_torch_gait.gait_pair) is exported at bucket
8 on the CPU; the program takes the real-frame count n_valid as an input
and reads it at run time. The BiGRU runs every layer and direction over
all T frames with the padded tail masked: it is held against nn.GRU on
each sequence's valid prefix (the form it replaces) and against gaitlab's
BiGRU with seq_lengths.

Tolerances: the program against the live runner it was exported from,
1e-5 on the per-frame outputs; the gait estimates 1e-4 (relative to their
largest value, 1e-5 absolute), as tests/test_torch_runner_gait.py holds
padded against exact; against gaitlab on the same weights
(gait_state_dict_from_flax) test_torch_models.assert_outputs_close; the
masked BiGRU against the sliced one, the same float32 recurrences,
1e-5 (1e-6 absolute), and against gaitlab 1e-4 as test_torch_gait.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaitlab.body import smpl as jax_smpl
from gaitlab.nn import gait as jax_gait
from gaitlab.nn.grnet import GRNet as JaxGRNet
from gaitlab.pipeline.runner import GRNetRunner as JaxRunner
from gaitlab_torch import serve
from gaitlab_torch.nn import gait as pt_gait
from gaitlab_torch.pipeline.crop import normalize_image
from gaitlab_torch.pipeline.runner import GRNetRunner
from test_torch_gait import flax_init, gait_inputs, gait_pair, port_module
from test_torch_models import assert_close
from test_torch_serve import CROP, PER_FRAME, edge_pad, outputs_close, \
    u8_crops
from torch_threads import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def gait_served(tmp_path_factory):
    module, variables, port = gait_pair(seed=5)
    runner = GRNetRunner(port, buckets=(8,), crop_size=CROP)
    art_dir = str(tmp_path_factory.mktemp("torch_serve_gait") / "artifacts")
    manifest = serve.save_artifacts(runner, art_dir, platforms=("cpu",))
    jax_model = JaxGRNet(module=module, variables=variables,
                         smpl=jax_smpl.synthetic_smpl_params())
    return runner, manifest, serve.load_artifacts(art_dir, device="cpu"), \
        jax_model


def test_gait_export_reads_n_valid_at_run_time(gait_served):
    runner, manifest, loaded, jax_model = gait_served
    assert manifest["gait"] and manifest["buckets"] == [8]
    n = 5
    crops = u8_crops(8, seed=3)
    _, bbox, cimg = gait_inputs(8)
    got = loaded.call(None, None, crops[:n], bbox=bbox[:n], cimg=cimg[:n])
    assert got["pred_avg"].shape == (1, 3) and got["pred_phase"].shape == (n, 4)

    # the live port runner on the same crops, padded to its bucket
    live = runner.forward_crops(normalize_image(torch.from_numpy(crops[:n])),
                                bbox=bbox[:n], cimg=cimg[:n])
    assert_close(got["pred_avg"][0], live["pred_avg"], rtol=1e-4, atol=1e-5,
                 what="pred_avg vs live")
    assert_close(got["pred_phase"], live["pred_phase"], rtol=1e-4, atol=1e-5,
                 what="pred_phase vs live")
    for k in PER_FRAME:
        assert_close(got[k], live[k], rtol=1e-5, atol=1e-5, what=k)

    # gaitlab's gait bucket forward on the same weights, crops and n_valid
    jax_runner = JaxRunner(jax_model, buckets=(8,), precision="float32",
                           crop_size=CROP)
    pad = [jnp.asarray(edge_pad(a[:n], 8)) for a in (crops, bbox, cimg)]
    want = jax_runner._forward(8, True)(
        jax_runner._trunk_variables(), jax_runner._smpl_params(), *pad,
        np.int32(n))
    assert_close(got["pred_avg"], want["pred_avg"], rtol=1e-4, atol=1e-5,
                 what="pred_avg vs gaitlab")
    assert_close(got["pred_phase"], np.asarray(want["pred_phase"])[:n],
                 rtol=1e-4, atol=1e-5, what="pred_phase vs gaitlab")
    outputs_close(got, want, n)

    # the same 8 rows with all of them real: another estimate
    full = loaded.call(None, None, edge_pad(crops[:n], 8),
                       bbox=edge_pad(bbox[:n], 8), cimg=edge_pad(cimg[:n], 8))
    assert np.abs(full["pred_avg"] - got["pred_avg"]).max() > 1e-4
    again = loaded.call(None, None, edge_pad(crops[:n], 8),
                        bbox=edge_pad(bbox[:n], 8),
                        cimg=edge_pad(cimg[:n], 8), n_valid=n)
    np.testing.assert_array_equal(again["pred_avg"], got["pred_avg"])


# ---------------------------------------------------------------------------
# the masked BiGRU
# ---------------------------------------------------------------------------

def sliced(gru: pt_gait.BiGRU, x: torch.Tensor, lengths):
    """nn.GRU on each sequence's valid prefix: the form the masked BiGRU
    replaces."""
    outs, finals = [], []
    for i, n in enumerate(lengths):
        o, f = torch.nn.GRU.forward(gru, x[i:i + 1, :n])
        outs.append(torch.nn.functional.pad(o, (0, 0, 0, x.shape[1] - n)))
        finals.append(f.permute(1, 0, 2).reshape(1, -1))
    return torch.cat(outs), torch.cat(finals)


@pytest.mark.parametrize("n", [9, 6, 1], ids=["T", "T-3", "one"])
def test_masked_bigru_matches_sliced_and_gaitlab(n):
    b, t, d, h = 2, 9, 12, 5
    lengths = [n, t]
    x = np.random.default_rng(6).normal(size=(b, t, d)).astype(np.float32)
    gru = jax_gait.BiGRU(hidden_size=h, num_layers=2)
    seq = jnp.asarray(lengths, jnp.int32)
    params = flax_init(gru, 2, jnp.asarray(x), seq)
    out_w, fin_w = gru.apply({"params": params}, jnp.asarray(x),
                             seq_lengths=seq)
    port = port_module(pt_gait.BiGRU(d, h, 2), params, prefix="rnn")
    with torch.no_grad():
        out_g, fin_g = port(torch.from_numpy(x), torch.tensor(lengths))
        out_s, fin_s = sliced(port, torch.from_numpy(x), lengths)
    assert_close(fin_g.numpy(), fin_s.numpy(), rtol=1e-5, atol=1e-6,
                 what="finals vs sliced")
    assert_close(out_g.numpy(), out_s.numpy(), rtol=1e-5, atol=1e-6,
                 what="outputs vs sliced (padded frames zero)")
    assert_close(fin_g.numpy(), np.asarray(fin_w), rtol=1e-4, atol=1e-5,
                 what="finals vs gaitlab")
    for i, m in enumerate(lengths):
        assert_close(out_g[i, :m].numpy(), np.asarray(out_w)[i, :m],
                     rtol=1e-4, atol=1e-5, what=f"outputs {i} vs gaitlab")
