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
taken in another order); keypoint attention 1e-4 (sums of 3136); the
bilinear resize none: it takes ATen's arithmetic, so its outputs equal
F.interpolate's bit for bit in every dtype. The emulations are held to
1e-5, as tests/test_pallas_ops.py holds the Pallas kernels.
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
from gaitlab_torch.ops import upsample_bilinear as pt_upsample
from gaitlab_torch.ops.upsample_bilinear import (upsample_bilinear_ac,
                                                 upsample_bilinear_plain)
from torch_threads import torch_threads  # noqa: F401


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


# ---------------------------------------------------------------------------
# the bilinear resize (ops/upsample_bilinear.py)
# ---------------------------------------------------------------------------

# (channels, in, out) of the deployed head's six resizes, then the
# resize of the heads without convolutions (7 -> 56)
HEAD_RESIZES = [(64, 28, 56), (128, 14, 28), (128, 28, 56), (256, 7, 14),
                (256, 14, 28), (256, 28, 56)]
RESIZES = HEAD_RESIZES + [(256, 7, 56)]


def emulate_cover(plan, planes, out_h, out_w):
    """How often the kernel's blocks and thread loops write each output of
    `planes` (out_h, out_w) planes: block b is plane group b // chunks and
    row chunk b % chunks; thread (tx, ty) writes column vectors tx, tx +
    bx, ... of tile rows ty, ty + by, ..., and tile row r lies at output
    row r0 + r of the group's first plane."""
    cnt = np.zeros(planes * out_h * out_w, np.int64)
    bx, by = plan.block
    chunks = -(-out_h // plan.row_tile)
    n_vec = out_w // plan.vec
    cvs = np.concatenate([np.arange(tx, n_vec, bx) for tx in range(bx)])
    cols = (cvs[:, None] * plan.vec + np.arange(plan.vec)).ravel()
    for b in range(plan.grid):
        g, c = divmod(b, chunks)
        p0, r0 = g * plan.plane_tile, c * plan.row_tile
        n_p = min(plan.plane_tile, planes - p0)
        n_r = min(plan.row_tile, out_h - r0)
        assert n_p > 0 and n_r > 0  # no empty block
        rows = np.concatenate([np.arange(ty, n_p * n_r, by)
                               for ty in range(by)])
        starts = (p0 * out_h + r0 + rows) * out_w
        np.add.at(cnt, (starts[:, None] + cols[None, :]).ravel(), 1)
    return cnt


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("c,size,out", RESIZES)
def test_upsample_plan_covers_each_output_once(n, elt, c, size, out):
    plan = pt_upsample.launch_plan(n * c, size, size, out, out, elt)
    assert (emulate_cover(plan, n * c, out, out) == 1).all()
    bx, by = plan.block
    assert bx * by <= pt_upsample.MAX_THREADS and bx <= out // plan.vec
    # rows of several planes only where a block holds whole planes
    assert plan.plane_tile == 1 or plan.row_tile == out
    assert plan.cap == (size if plan.row_tile == out else
                        pt_upsample.rows_cap(size, out, plan.row_tile))
    assert plan.smem == pt_upsample.smem_bytes(
        plan.plane_tile, plan.row_tile, plan.cap, size, elt)
    assert plan.smem <= pt_upsample.MAX_SMEM


@pytest.mark.parametrize("elt,out,vec", [(4, 56, 4), (4, 28, 4), (4, 14, 2),
                                         (2, 56, 8), (2, 28, 4), (2, 14, 2)])
def test_upsample_plan_stores_16_bytes_where_a_row_allows(elt, out, vec):
    """16-byte stores at widths 56 and 28, and at width 14 the 2-wide
    vector (8 bytes in float32) that divides the row; an output aligned to
    4 bytes only is written a value at a time in float32."""
    assert pt_upsample.launch_plan(256, out // 2, out // 2, out, out,
                                   elt).vec == vec
    plan = pt_upsample.launch_plan(3, 7, 7, 14, 14, 4, align=4)
    assert plan.vec == 1 and (emulate_cover(plan, 3, 14, 14) == 1).all()


def source_taps(in_size, out_size, dst):
    """The kernel's (and ATen's) first tap and step of each destination
    index, in float32: scale = (in - 1) / (out - 1), r = scale * dst."""
    scale = (np.float32(in_size - 1) / np.float32(out_size - 1)
             if out_size > 1 else np.float32(0))
    i0 = (scale * np.asarray(dst).astype(np.float32)).astype(np.int64)
    return i0, (i0 < in_size - 1).astype(np.int64)


@pytest.mark.parametrize("in_hw,out_hw", [((512, 512), (64, 64)),
                                          ((7, 9), (224, 300)),
                                          ((100, 37), (999, 41)),
                                          ((1000, 64), (61, 8))])
def test_upsample_plan_stages_the_rows_its_taps_reach(in_hw, out_hw):
    """Large planes are split into chunks of output rows: each chunk's
    taps reach no more input rows than the block stages, and the staged
    rows fit in shared memory."""
    (in_h, in_w), (out_h, out_w) = in_hw, out_hw
    plan = pt_upsample.launch_plan(2, in_h, in_w, out_h, out_w)
    assert plan.row_tile < out_h and plan.plane_tile == 1
    assert (emulate_cover(plan, 2, out_h, out_w) == 1).all()
    assert plan.cap == pt_upsample.rows_cap(in_h, out_h, plan.row_tile)
    assert plan.smem == pt_upsample.smem_bytes(1, plan.row_tile, plan.cap,
                                               in_w, 4)
    assert plan.smem <= pt_upsample.MAX_SMEM
    i0, step = source_taps(in_h, out_h, np.arange(out_h))
    for r0 in range(0, out_h, plan.row_tile):
        last = min(out_h, r0 + plan.row_tile) - 1
        assert i0[last] + step[last] - i0[r0] + 1 <= plan.cap


def test_upsample_plan_refuses_rows_too_wide():
    with pytest.raises(ValueError, match="shared memory"):
        pt_upsample.launch_plan(1, 4, 40000, 4, 16)


def test_upsample_plan_matches_the_kernel_source():
    src = open(_build._target("upsample_bilinear")[0]).read()
    assert f"constexpr int kMaxThreads = {pt_upsample.MAX_THREADS};" in src


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,size", [((2, 5, 7, 7), (14, 14)),
                                        ((1, 3, 7, 7), (56, 56)),
                                        ((2, 2, 9, 13), (4, 6)),
                                        ((1, 2, 6, 6), (6, 6))])
def test_upsample_cpu_tensors_take_the_plain_version(dtype, shape, size):
    x = torch.randn(*shape).to(dtype)
    n = upsample_bilinear_ac.launches
    want = torch.nn.functional.interpolate(x, size=size, mode="bilinear",
                                           align_corners=True)
    torch.testing.assert_close(upsample_bilinear_ac(x, *size), want,
                               rtol=0, atol=0)
    torch.testing.assert_close(upsample_bilinear_plain(x, *size), want,
                               rtol=0, atol=0)
    assert upsample_bilinear_ac.launches == n


def test_upsample_cpu_gradient_is_interpolates():
    x = torch.randn(2, 3, 7, 9, dtype=torch.float64, requires_grad=True)
    g = torch.randn(2, 3, 14, 17, dtype=torch.float64)
    n = upsample_bilinear_ac.backwards
    (got,) = torch.autograd.grad(upsample_bilinear_ac(x, 14, 17), x, g)
    (want,) = torch.autograd.grad(torch.nn.functional.interpolate(
        x, size=(14, 17), mode="bilinear", align_corners=True), x, g)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert upsample_bilinear_ac.backwards == n + 1
    torch.autograd.gradcheck(lambda a: upsample_bilinear_ac(a, 5, 4),
                             (x[:1, :1, :3, :3].detach().requires_grad_(),))


def test_upsample_exports_through_its_fake():
    class Resize(torch.nn.Module):
        def forward(self, x):
            y = upsample_bilinear_ac(x, 2 * x.shape[-2], 2 * x.shape[-1])
            return upsample_bilinear_ac(y, 56, 56)

    x = torch.randn(2, 4, 7, 7)
    ep = torch.export.export(Resize(), (x,))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count("gaitlab.upsample_bilinear_ac.default") == 2
    out = [n for n in ep.graph.nodes if n.op == "output"][0].args[0][0]
    assert tuple(out.meta["val"].shape) == (2, 4, 56, 56)
    torch.testing.assert_close(ep.module()(x), Resize()(x), rtol=0, atol=0)


def test_upsample_never_falls_back():
    """A tensor neither on the CPU nor on a CUDA device is refused, and the
    op's CUDA implementation refuses a CPU tensor."""
    with pytest.raises(ValueError, match="CUDA device"):
        upsample_bilinear_ac(torch.zeros(1, 2, 7, 7, device="meta"), 14, 14)
    with pytest.raises(ValueError, match="CUDA device"):
        pt_upsample._launch(torch.zeros(1, 2, 7, 7), 14, 14)


def test_deployed_head_resizes_on_the_op(monkeypatch):
    """The deployed head keeps the reference's state_dict keys and
    Sequential indices, holds no bilinear nn.Upsample, and resizes six
    times a forward through the op (the head without convolutions three
    times, through layers.upsample_bilinear_align_corners)."""
    from gaitlab_torch.nn import hrnet, layers

    net = hrnet.PoseHighResolutionNet(hrnet.HRNetCfg.w(32))
    want = set()
    for stage, ch, reps in ((2, 64, 1), (3, 128, 2), (4, 256, 3)):
        seq = getattr(net, f"upsample_stage_{stage}")
        assert len(seq) == 4 * reps
        for k in range(reps):
            assert isinstance(seq[4 * k], layers.UpsampleBilinear2x)
            assert seq[4 * k + 1].weight.shape == (ch, ch, 3, 3)
            want |= {f"upsample_stage_{stage}.{4 * k + 1}.weight"} | {
                f"upsample_stage_{stage}.{4 * k + 2}.{key}" for key in (
                    "weight", "bias", "running_mean", "running_var",
                    "num_batches_tracked")}
    assert {k for k in net.state_dict()
            if k.startswith("upsample_stage_")} == want
    # the fuse layers keep ATen's nearest upsampling
    assert not [m for m in net.modules()
                if isinstance(m, torch.nn.Upsample) and m.mode != "nearest"]

    sizes = []

    def spy(x, out_h, out_w):
        sizes.append((x.shape[1], x.shape[-1], out_w))
        return upsample_bilinear_ac(x, out_h, out_w)

    monkeypatch.setattr(layers, "upsample_bilinear_ac", spy)
    small = hrnet.HRNetCfg.w(4, modules=(1, 1, 1), blocks=1)
    x = torch.randn(1, 3, 64, 64)
    with torch.no_grad():
        assert hrnet.PoseHighResolutionNet(small).eval()(x).shape == (
            1, 60, 16, 16)
        assert sorted(sizes) == sorted([(8, 8, 16), (16, 4, 8), (16, 8, 16),
                                        (32, 2, 4), (32, 4, 8), (32, 8, 16)])
        sizes.clear()
        plain = hrnet.HRNetCfg.w(4, use_conv=False, modules=(1, 1, 1),
                                 blocks=1)
        hrnet.PoseHighResolutionNet(plain).eval()(x)
        assert sorted(sizes) == [(8, 8, 16), (16, 4, 16), (32, 2, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 37, 128, 450])
@pytest.mark.parametrize("c,size,out", HEAD_RESIZES)
def test_upsample_kernel_on_card(cuda, n, c, size, out):
    """At the head's six resizes, float32 equals ATen's kernel bit for bit,
    and so do bfloat16 and float16; one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(n * c + size)
    x = torch.randn(n, c, size, size, device=cuda, generator=g)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        xd = x.to(dtype)
        k = upsample_bilinear_ac.launches
        got = upsample_bilinear_ac(xd, out, out)
        torch.cuda.synchronize()
        assert upsample_bilinear_ac.launches == k + 1
        assert got.dtype == dtype and got.shape == (n, c, out, out)
        torch.testing.assert_close(got, upsample_bilinear_plain(xd, out, out),
                                   rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,size", [((3, 256, 7, 7), (56, 56)),
                                        ((2, 5, 56, 56), (28, 28)),
                                        ((2, 3, 29, 13), (7, 50)),
                                        ((1, 2, 512, 512), (64, 64)),
                                        ((2, 3, 7, 9), (224, 300)),
                                        ((2, 3, 6, 6), (6, 6)),
                                        ((4, 3, 1, 5), (1, 9))])
def test_upsample_kernel_any_size_on_card(cuda, shape, size):
    """Up and down, a ragged width (one value a store), planes split into
    chunks of rows, equal sizes (a copy) and single rows."""
    g = torch.Generator(device=cuda).manual_seed(shape[-1])
    x = torch.randn(*shape, device=cuda, generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        got = upsample_bilinear_ac(x.to(dtype), *size)
        torch.testing.assert_close(
            got, upsample_bilinear_plain(x.to(dtype), *size), rtol=0, atol=0)


@pytest.mark.gpu
def test_upsample_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(2, 4, 7, 7, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        upsample_bilinear_ac(x.transpose(2, 3), 14, 14)
    with pytest.raises(ValueError, match="contiguous"):
        upsample_bilinear_ac(x[0], 14, 14)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        upsample_bilinear_ac(x.double(), 14, 14)
    with pytest.raises(ValueError, match="CUDA device"):
        upsample_bilinear_ac(x.to("meta"), 14, 14)
