"""The port's kernel wrappers (gaitlab_torch/ops).

On the CPU: the wrappers take the plain version for CPU tensors only,
refuse every other device, count no launch, read NCHW tensors through
strides, and the build needs nvcc and says so. The launch plans cover
every position and row once within Hopper's shared memory, and numpy
emulations of the kernels' arithmetic (keypoint attention's split online
softmax and merge; blendshapes' 3xTF32 products) match gaitlab. On a card
(tests marked `gpu`, skipped without one): each CUDA kernel against its
plain version at the main path's shapes (keypoint attention on float32
and on bf16 inputs; tests/test_torch_attention_bf16.py holds the bf16
kernel's own tests). Only the emulation tests import
gaitlab (and so JAX), inside the test, so the card's machine, which has no
JAX, runs the card tests without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tolerances on the card: blendshapes 1e-5 (sums of 217 float32 products
taken in another order); keypoint attention 1e-4 (sums of 3136). The
emulations are held to 1e-5, as tests/test_pallas_ops.py holds the Pallas
kernels.
"""

import numpy as np
import pytest
import torch

from gaitlab_torch.device import float32_math
from gaitlab_torch.ops import _build
from gaitlab_torch.ops import blendshapes as pt_blendshapes
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
# launch plans
# ---------------------------------------------------------------------------

PLAN_BATCHES = [1, 37, 64, 128, 256, 450]  # ragged sizes and the buckets
H100_SMS = 132


@pytest.mark.parametrize("b", PLAN_BATCHES)
@pytest.mark.parametrize("hw", [56 * 56, 23 * 29, 63])
def test_attention_plan_covers_each_position_once(b, hw):
    plan = pt_attention.launch_plan(b, hw, 192, H100_SMS)
    assert plan.split_len % pt_attention.KERNEL_TILE == 0
    covered = np.zeros(hw, int)
    for split in range(plan.n_split):
        run = covered[split * plan.split_len:(split + 1) * plan.split_len]
        assert run.size > 0  # no empty split
        run += 1
    assert (covered == 1).all()
    assert plan.n_chunk * pt_attention.KERNEL_CHANNELS >= 192
    assert plan.smem <= pt_attention.MAX_SMEM
    assert 1 <= plan.blocks_per_sm <= pt_attention.KERNEL_BLOCKS
    assert plan.blocks_per_sm * (plan.smem + pt_attention.SMEM_RESERVED) \
        <= pt_attention.SMEM_PER_SM


@pytest.mark.parametrize("b", PLAN_BATCHES)
@pytest.mark.parametrize("rows,align,vec", [(20670, 256, 2), (20672, 256, 4),
                                            (20672, 8, 2), (1293, 256, 1)])
def test_blendshapes_plan_covers_each_row_once(b, rows, align, vec):
    plan = pt_blendshapes.launch_plan(b, rows, 10, 207, align=align)
    gx, gy = plan.grid
    for n, tile, g in ((rows, pt_blendshapes.ROW_TILE, gx),
                       (b, pt_blendshapes.BATCH_TILE, gy)):
        covered = np.zeros(n, int)
        for i in range(g):
            run = covered[i * tile:(i + 1) * tile]
            assert run.size > 0  # no empty block
            run += 1
        assert (covered == 1).all()
    assert plan.vec == vec
    assert plan.smem <= pt_blendshapes.MAX_SMEM
    # the output tile is staged in the same shared memory at the end
    assert plan.smem >= 4 * pt_blendshapes.BATCH_TILE * pt_blendshapes.OUT_STRIDE


def test_blendshapes_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        pt_blendshapes.launch_plan(128, 20670, 10, 400)


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated in numpy and held against gaitlab
# ---------------------------------------------------------------------------

LOG2E = np.float32(1.4426950408889634)


def emulate_split_attention(feat, hm, plan):
    """csrc/keypoint_attention.cu in float32: feat (B, C, HW), hm (B, J, HW)
    -> (B, J, C). Each split streams tiles of KERNEL_TILE positions with a
    running max m of the logits per part and sums weighted by
    2^((logit - m) * log2(e)), rescaled when m rises; the merge rescales
    the splits to their common max and adds them in split order."""
    b, c, hw = feat.shape
    j = hm.shape[1]
    tile = pt_attention.KERNEL_TILE
    ms, accs = [], []
    for split in range(plan.n_split):
        m = np.full((b, j), -np.inf, np.float32)
        s = np.zeros((b, j), np.float32)
        acc = np.zeros((b, j, c), np.float32)
        end = min(hw, (split + 1) * plan.split_len)
        for p0 in range(split * plan.split_len, end, tile):
            l = hm[:, :, p0:min(end, p0 + tile)]
            mn = np.maximum(m, l.max(-1))
            alpha = np.where(mn == m, np.float32(1),
                             np.exp2((m - mn) * LOG2E))
            w = np.exp2((l - mn[..., None]) * LOG2E).astype(np.float32)
            s = s * alpha + w.sum(-1, dtype=np.float32)
            acc = acc * alpha[..., None] + np.einsum(
                "bjt,bct->bjc", w, feat[:, :, p0:p0 + w.shape[-1]])
            m = mn
        ms.append((m, s))
        accs.append(acc)
    if plan.n_split == 1:
        return accs[0] / ms[0][1][..., None]
    mx = np.max([m for m, _ in ms], axis=0)
    num = np.zeros_like(accs[0])
    den = np.zeros_like(ms[0][1])
    for (m, s), acc in zip(ms, accs):
        a = np.where(m == -np.inf, np.float32(0), np.exp2((m - mx) * LOG2E))
        num = num + a[..., None] * acc
        den = den + a * s
    return num / den[..., None]


@pytest.mark.parametrize("h,w", [(56, 56), (23, 29)])
@pytest.mark.parametrize("negative", ["none", "one_split", "whole_part"])
def test_split_softmax_emulation_matches_gaitlab(h, w, negative):
    """At HW = 3136 and at a ragged HW = 667 (11 splits, the last of 27
    positions), with the splits and tiles of the kernel's plan at B = 2.
    `one_split`: part 0's logits in the first split all near -1e4, so that
    split adds nothing; `whole_part`: part 1's logits all near -1e4, so the
    running max alone keeps its softmax finite."""
    import jax.numpy as jnp

    from gaitlab.nn.layers import keypoint_attention as jax_attention

    rng = np.random.default_rng(7)
    b, c, j, hw = 2, 192, 24, h * w
    feat = rng.normal(size=(b, c, hw)).astype(np.float32)
    hm = (rng.normal(size=(b, j, hw)) * 3).astype(np.float32)
    plan = pt_attention.launch_plan(b, hw, c, H100_SMS)
    assert plan.n_split > 1  # the merge is exercised
    if negative == "one_split":
        hm[:, 0, :plan.split_len] -= 1e4
    elif negative == "whole_part":
        hm[:, 1] -= 1e4
    got = emulate_split_attention(feat, hm, plan)
    want = jax_attention(jnp.asarray(feat.transpose(0, 2, 1).reshape(b, h, w, c)),
                         jnp.asarray(hm.transpose(0, 2, 1).reshape(b, h, w, j)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def emulate_3xtf32(coef, dirs):
    """coef (B, K) . dirs (K, R) as csrc/blendshapes.cu multiplies: each
    factor split into big = tf32(x) and small = tf32(x - big), each product
    small*big + big*small + big*big, summed in float32 over k in order."""
    cb, db = tf32(coef), tf32(dirs)
    cs, ds = tf32(coef - cb), tf32(dirs - db)
    acc = np.zeros((coef.shape[0], dirs.shape[1]), np.float32)
    for k in range(coef.shape[1]):
        for a, d in ((cs, db), (cb, ds), (cb, db)):
            acc = acc + np.outer(a[:, k], d[k])  # exact: 11 x 11 bits
    return acc


def test_3xtf32_emulation_matches_gaitlab():
    """The kernel's 3xTF32 products keep float32 parity with gaitlab's
    blendshapes reference (tolerance 1e-5), and err far less than single
    TF32 products would."""
    import jax.numpy as jnp

    from gaitlab.ops.lbs_pallas import blendshapes_reference

    rng = np.random.default_rng(3)
    v, s, p, b = 431, 10, 207, 5
    vt = (rng.normal(size=(v, 3)) * 0.3).astype(np.float32)
    sh = (rng.normal(size=(v, 3, s)) * 0.01).astype(np.float32)
    po = (rng.normal(size=(p, v * 3)) * 0.001).astype(np.float32)
    be = rng.normal(size=(b, s)).astype(np.float32)
    pf = (rng.normal(size=(b, p)) * 0.5).astype(np.float32)
    coef = np.concatenate([be, pf], 1)
    dirs = np.concatenate([sh.reshape(v * 3, s).T, po])
    got = vt.reshape(1, -1) + emulate_3xtf32(coef, dirs)
    want = np.asarray(blendshapes_reference(*map(jnp.asarray,
                                                 (vt, sh, po, be, pf))))
    want = want.reshape(b, -1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    exact = vt.reshape(1, -1).astype(np.float64) + coef.astype(
        np.float64) @ dirs.astype(np.float64)
    one_tf32 = vt.reshape(1, -1) + tf32(coef) @ tf32(dirs)
    assert np.abs(got - exact).max() * 10 < np.abs(one_tf32 - exact).max()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 37, 128, 450])
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
@pytest.mark.parametrize("b", [1, 37, 128, 450])
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
@pytest.mark.parametrize("v,b", [(431, 37), (6892, 130)])
def test_blendshapes_kernel_row_widths_on_card(cuda, v, b):
    """R = 3V odd (4-byte copies of posedirs rows) and a multiple of 4
    (16-byte copies), the second with two batch tiles."""
    g = torch.Generator(device=cuda).manual_seed(v)
    args = (torch.randn(v, 3, device=cuda, generator=g) * 0.3,
            torch.randn(v, 3, 10, device=cuda, generator=g) * 0.01,
            torch.randn(207, v * 3, device=cuda, generator=g) * 0.001,
            torch.randn(b, 10, device=cuda, generator=g),
            torch.randn(b, 207, device=cuda, generator=g) * 0.5)
    got = blendshapes(*args)
    with float32_math():
        want = blendshapes_plain(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(14, 14), (7, 9)])
def test_keypoint_attention_kernel_nhwc_on_card(cuda, h, w):
    """Contiguous NHWC tensors (4-byte copies through the strides) with
    256 + 64 channels (two channel chunks) and a ragged HW."""
    g = torch.Generator(device=cuda).manual_seed(h * w)
    args = (torch.randn(3, h, w, 256, device=cuda, generator=g),
            torch.randn(3, h, w, 64, device=cuda, generator=g),
            torch.randn(3, h, w, 24, device=cuda, generator=g) * 3)
    got = keypoint_attention_fused(*args)
    with float32_math():
        want = keypoint_attention_plain(*args)
    for a, x in zip(got, want):
        torch.testing.assert_close(a, x, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 37, 128, 450])
def test_keypoint_attention_kernel_on_bf16_on_card(cuda, b):
    """bf16 NCHW views, which the bf16 kernel's TMA maps read as they lie,
    and contiguous bf16 NHWC tensors with a ragged HW, which the wrapper
    first copies into the head's layout (once per call): float32 outputs,
    against the plain version on the upcast inputs."""
    g = torch.Generator(device=cuda).manual_seed(b)
    bf = torch.bfloat16
    f = torch.randn(b, 128, 56, 56, device=cuda, generator=g).relu().to(bf)
    c = torch.randn(b, 64, 56, 56, device=cuda, generator=g).to(bf)
    hm = (torch.randn(b, 25, 56, 56, device=cuda, generator=g) * 3).to(bf)
    nhwc = tuple(torch.randn(2, 7, 9, ch, device=cuda, generator=g).to(bf)
                 for ch in (256, 64, 24))
    for args, copies in (((f.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1),
                           hm[:, 1:].permute(0, 2, 3, 1)), 0), (nhwc, 1)):
        n = (keypoint_attention_fused.launches_bf16,
             keypoint_attention_fused.copies_bf16)
        got = keypoint_attention_fused(*args)
        torch.cuda.synchronize()
        assert (keypoint_attention_fused.launches_bf16,
                keypoint_attention_fused.copies_bf16) == (n[0] + 1,
                                                          n[1] + copies)
        want = keypoint_attention_plain(*args)
        for a, w in zip(got, want):
            assert a.dtype == torch.float32
            torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="bfloat16"):
        keypoint_attention_fused(nhwc[0], nhwc[1].float(), nhwc[2])


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
