"""The port's two kernels (gaitlab_torch/ops) against gaitlab's Pallas
kernels, which run in interpret mode here as tests/test_pallas_ops.py runs
them.

On the CPU a wrapper computes its plain PyTorch version; the CUDA kernels
themselves are held against the plain versions by
tests/test_torch_kernels.py on a card and by chip_smoke.py. Tolerance
1e-5, as in test_pallas_ops.py: both sides sum the same float32 products
in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaitlab.nn.layers import keypoint_attention as jax_attention
from gaitlab.ops import lbs_pallas
from gaitlab.ops.attention_pallas import \
    keypoint_attention_fused as jax_keypoint_attention_fused
from gaitlab_torch.ops.blendshapes import blendshapes, blendshapes_plain
from gaitlab_torch.ops.keypoint_attention import (keypoint_attention_fused,
                                                  keypoint_attention_plain)
from test_torch_kernels import attention_inputs, blendshape_inputs
from torch_threads import torch_threads  # noqa: F401


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def jax_args(args):
    return [jnp.asarray(a.numpy()) for a in args]


@pytest.mark.parametrize("b", [1, 5, 37])
def test_blendshapes_matches_pallas(rng, b):
    args = blendshape_inputs(rng, b=b)  # odd V, B: the Pallas padding
    want = lbs_pallas.blendshapes(*jax_args(args), interpret=True)
    got = blendshapes(*args)
    assert got.shape == (b, 431, 3) and got.dtype == torch.float32
    close(got, want)


@pytest.mark.parametrize("hw", [(14, 14), (7, 9)])
def test_keypoint_attention_matches_pallas(rng, hw):
    args = attention_inputs(rng, h=hw[0], w=hw[1])
    want = jax_keypoint_attention_fused(*jax_args(args), interpret=True)
    for g, w in zip(keypoint_attention_fused(*args), want):
        close(g, w)


def test_plain_versions_are_what_the_pallas_references_compute(rng):
    """The plain versions against gaitlab's plain XLA references."""
    args = blendshape_inputs(rng, b=3)
    close(blendshapes_plain(*args),
          lbs_pallas.blendshapes_reference(*jax_args(args)))
    f, c, hm = args = attention_inputs(rng)
    _, _, jax_hm = jax_args(args)
    for g, x in zip(keypoint_attention_plain(f, c, hm), jax_args((f, c))):
        close(g, jax_attention(x, jax_hm))
