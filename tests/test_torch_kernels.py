"""The port's kernel wrappers (gaitlab_torch/ops), without JAX.

On the CPU: the wrappers take the plain version for CPU tensors only,
refuse every other device, count no launch, read NCHW tensors through
strides, and the build needs nvcc and says so. On a card (tests marked
`gpu`, skipped without one): each CUDA kernel against its plain version at
the main path's shapes. This file imports nothing of JAX, so the card's
machine, which has no JAX, runs it without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tolerances on the card: blendshapes 1e-5 (sums of 217 float32 products
taken in another order); keypoint attention 1e-4 (sums of 3136).
"""

import numpy as np
import pytest
import torch

from gaitlab_torch.device import float32_math
from gaitlab_torch.ops import _build
from gaitlab_torch.ops import keypoint_attention as pt_attention
from gaitlab_torch.ops.blendshapes import blendshapes, blendshapes_plain
from gaitlab_torch.ops.keypoint_attention import (keypoint_attention_fused,
                                                  keypoint_attention_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    return torch.device("cuda")


def blendshape_inputs(rng, v=431, s=10, p=207, b=5):
    return tuple(torch.from_numpy(a) for a in (
        rng.normal(size=(v, 3)).astype(np.float32),
        (rng.normal(size=(v, 3, s)) * 0.1).astype(np.float32),
        (rng.normal(size=(p, v * 3)) * 0.01).astype(np.float32),
        rng.normal(size=(b, s)).astype(np.float32),
        (rng.normal(size=(b, p)) * 0.1).astype(np.float32)))


def attention_inputs(rng, b=3, h=14, w=14, c1=128, c2=64, j=24):
    return tuple(torch.from_numpy(a) for a in (
        rng.normal(size=(b, h, w, c1)).astype(np.float32),
        rng.normal(size=(b, h, w, c2)).astype(np.float32),
        (rng.normal(size=(b, h, w, j)) * 3).astype(np.float32)))


def test_keypoint_attention_takes_nchw_views():
    """The PARE head hands NCHW tensors over as permuted NHWC views, with
    the background channel sliced off the logits."""
    rng = np.random.default_rng(0)
    f, c, hm = attention_inputs(rng)
    hm25 = torch.cat([torch.randn(hm.shape[:3] + (1,)), hm], dim=-1)
    nchw = [a.permute(0, 3, 1, 2).contiguous() for a in (f, c, hm25)]
    views = (nchw[0].permute(0, 2, 3, 1), nchw[1].permute(0, 2, 3, 1),
             nchw[2][:, 1:].permute(0, 2, 3, 1))
    for g, w in zip(keypoint_attention_fused(*views),
                    keypoint_attention_fused(f, c, hm)):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_position_strides():
    x = torch.zeros(2, 5, 7, 3)  # NHWC
    assert pt_attention._position_strides(x, "x") == (105, 3, 1)
    y = torch.zeros(2, 3, 5, 7).permute(0, 2, 3, 1)  # NCHW view
    assert pt_attention._position_strides(y, "y") == (105, 1, 35)
    z = torch.zeros(2, 3, 5, 8)[..., :7].permute(0, 2, 3, 1)  # padded rows
    with pytest.raises(ValueError, match="evenly strided"):
        pt_attention._position_strides(z, "z")


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(1)
    bs, at = blendshape_inputs(rng), attention_inputs(rng)
    n_b, n_a = blendshapes.launches, keypoint_attention_fused.launches
    torch.testing.assert_close(blendshapes(*bs), blendshapes_plain(*bs),
                               rtol=0, atol=0)
    for g, w in zip(keypoint_attention_fused(*at),
                    keypoint_attention_plain(*at)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # no kernel ran, so no launch was counted
    assert (blendshapes.launches, keypoint_attention_fused.launches) == (
        n_b, n_a)


def test_non_cpu_inputs_never_fall_back():
    """A tensor off the CPU goes to the kernel or raises: inputs on the
    meta device (neither CPU nor CUDA) or on mixed devices are refused."""
    rng = np.random.default_rng(2)
    bs, at = blendshape_inputs(rng), attention_inputs(rng)
    with pytest.raises(ValueError, match="CUDA device"):
        blendshapes(*(a.to("meta") for a in bs))
    with pytest.raises(ValueError, match="CUDA device"):
        blendshapes(*bs[:4], bs[4].to("meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        keypoint_attention_fused(*(a.to("meta") for a in at))


def test_build_needs_nvcc_and_builds_nothing_at_import(tmp_path, monkeypatch):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "ext"))
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
    # one library per source, named by the hash of source and flags
    src, so = _build._target("blendshapes")
    assert src.endswith("csrc/blendshapes.cu") and so.endswith(".so")
    assert so.startswith(_build.BUILD_DIR)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 37, 128])
def test_blendshapes_kernel_on_card(cuda, b):
    g = torch.Generator(device=cuda).manual_seed(b)
    v, s, p = 6890, 10, 207
    args = (torch.randn(v, 3, device=cuda, generator=g) * 0.3,
            torch.randn(v, 3, s, device=cuda, generator=g) * 0.01,
            torch.randn(p, v * 3, device=cuda, generator=g) * 0.001,
            torch.randn(b, s, device=cuda, generator=g),
            torch.randn(b, p, device=cuda, generator=g) * 0.5)
    n = blendshapes.launches
    got = blendshapes(*args)
    torch.cuda.synchronize()
    assert blendshapes.launches == n + 1
    with float32_math():
        want = blendshapes_plain(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 37, 128])
def test_keypoint_attention_kernel_on_card(cuda, b):
    g = torch.Generator(device=cuda).manual_seed(b)
    f = torch.randn(b, 128, 56, 56, device=cuda, generator=g).relu()
    c = torch.randn(b, 64, 56, 56, device=cuda, generator=g)
    hm = torch.randn(b, 25, 56, 56, device=cuda, generator=g) * 3
    args = (f.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1),
            hm[:, 1:].permute(0, 2, 3, 1))
    n = keypoint_attention_fused.launches
    got = keypoint_attention_fused(*args)
    torch.cuda.synchronize()
    assert keypoint_attention_fused.launches == n + 1
    with float32_math():
        want = keypoint_attention_plain(*args)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(2, 8, 8, 24, device=cuda)
    with pytest.raises(ValueError, match="parts"):
        keypoint_attention_fused(x, x, x[..., :10])
    with pytest.raises(ValueError, match="float32"):
        keypoint_attention_fused(x.double(), x, x)
    vt = torch.zeros(5, 3, device=cuda)
    with pytest.raises(ValueError, match="contiguous float32"):
        blendshapes(vt, torch.zeros(5, 3, 10, device=cuda),
                    torch.zeros(15, 207, device=cuda).t(),
                    torch.zeros(2, 10, device=cuda),
                    torch.zeros(2, 207, device=cuda))
