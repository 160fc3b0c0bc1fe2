"""Keypoint-attention pooling on bf16 inputs: csrc/keypoint_attention_bf16.cu.

On the CPU: a numpy emulation of the kernel's arithmetic (per-split max,
exp2 weights split into three bf16 parts, FP32 sums of exact products in
the order of the wgmma k-steps, the merge) matches gaitlab's Pallas kernel
in interpret mode on bf16 inputs; the three-part split is exact, and one
part alone errs ten times more; `launch_plan_bf16` covers every position
once in whole tiles; the wrapper's layout rule says which tensors TMA
reads as they lie and copies the others into the head's layout; the
Python plan agrees with the kernel's constants. On a card (tests marked
`gpu`, skipped without one): the kernel against the plain version on the
head's views and on contiguous NHWC tensors with a ragged H*W. Only the
emulation tests import gaitlab (and so JAX), inside the test, so the
card's machine runs the card tests without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_attention_bf16.py

Tolerances: the emulation against gaitlab 1e-5, as tests/test_pallas_ops.py
holds the Pallas kernel; the kernel against the plain version on the card
1e-4 (sums of 3136 FP32 products in another order), the smoke's B1_ATOL.
"""

import os.path as osp
import re

import numpy as np
import pytest
import torch

from gaitlab_torch.ops import _build
from gaitlab_torch.ops import keypoint_attention as pt_attention
from gaitlab_torch.ops.keypoint_attention import (keypoint_attention_fused,
                                                  keypoint_attention_plain,
                                                  launch_plan_bf16)

H100_SMS = 132
LOG2E = np.float32(1.4426950408889634)
K_STEP = 16  # positions of one wgmma (k16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    return torch.device("cuda")


def bf16(x):
    """Round float32 to bf16 (8 significant bits), to nearest even, as
    cvt.rn.bf16x2.f32 does; returned as float32."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    bits = bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    return (bits & np.uint32(0xFFFF0000)).view(np.float32)


def split3(w):
    """The kernel's three bf16 parts of FP32 weights: each rounds what the
    earlier ones left."""
    parts, r = [], np.asarray(w, np.float32)
    for _ in range(3):
        p = bf16(r)
        parts.append(p)
        r = (r - p).astype(np.float32)
    return parts


def emulate_bf16_attention(feat, hm, plan, n_parts=3, flush_subnormal=False):
    """csrc/keypoint_attention_bf16.cu in float32: feat (B, C, HW), hm
    (B, J, HW), bf16 values -> (B, J, C). Per split: the parts' max m over
    the split's logits, w = 2^((logit - m) * log2(e)), s its FP32 sum; the
    weights' first `n_parts` bf16 parts (a part below 2^-126 set to 0 with
    `flush_subnormal`) times the features, summed in FP32 one k-step of 16
    positions at a time, each part apart, then added smallest first; the
    merge of csrc/attention_merge.cuh."""
    b, c, hw = feat.shape
    ms, accs = [], []
    for split in range(plan.n_split):
        p0 = split * plan.split_len
        p1 = min(hw, p0 + plan.split_len)
        l = hm[:, :, p0:p1]
        m = l.max(-1)
        w = np.where(l == -np.inf, np.float32(0),
                     np.exp2((l - m[..., None]) * LOG2E)).astype(np.float32)
        s = w.sum(-1, dtype=np.float32)
        parts = split3(w)[:n_parts]
        if flush_subnormal:
            parts = [np.where(np.abs(p) < 2.0**-126, np.float32(0), p)
                     for p in parts]
        sums = []
        for p in parts:
            acc = np.zeros((b, w.shape[1], c), np.float32)
            for k in range(0, p1 - p0, K_STEP):
                acc += np.einsum("bjk,bck->bjc", p[..., k:k + K_STEP],
                                 feat[:, :, p0 + k:min(p1, p0 + k + K_STEP)])
            sums.append(acc)
        acc = sums[0]
        if n_parts == 3:
            acc = (sums[2] + sums[1]) + sums[0]
        ms.append((m, s))
        accs.append(acc)
    if plan.n_split == 1:
        return accs[0] * (np.float32(1) / ms[0][1])[..., None]
    mx = np.max([m for m, _ in ms], axis=0)
    num = np.zeros_like(accs[0])
    den = np.zeros_like(ms[0][1])
    for (m, s), acc in zip(ms, accs):
        a = np.where(m == -np.inf, np.float32(0),
                     np.exp2((m - mx) * LOG2E)).astype(np.float32)
        num = num + a[..., None] * acc
        den = den + a * s
    return num / den[..., None]


def bf16_inputs(rng, b, h, w, scale=3.0):
    """feat (B, 192, HW) and hm (B, 24, HW), float32 holding bf16 values."""
    feat = bf16(rng.normal(size=(b, 192, h * w)))
    hm = bf16(rng.normal(size=(b, 24, h * w)) * scale)
    return feat, hm


def gaitlab_bf16(feat, hm, h, w):
    """gaitlab's Pallas kernel in interpret mode on bf16 arrays (its
    wrapper upcasts them), as (B, J, 192)."""
    import jax.numpy as jnp

    from gaitlab.ops.attention_pallas import keypoint_attention_fused as pallas

    b = feat.shape[0]

    def nhwc(x):
        return jnp.asarray(x.transpose(0, 2, 1).reshape(b, h, w, -1),
                           dtype=jnp.bfloat16)

    f = nhwc(feat)
    got = pallas(f[..., :128], f[..., 128:], nhwc(hm), interpret=True)
    return np.concatenate([np.asarray(g) for g in got], -1)


@pytest.mark.parametrize("h,w", [(56, 56), (23, 29)])
@pytest.mark.parametrize("negative", ["none", "one_split", "whole_part"])
def test_bf16_emulation_matches_gaitlab(h, w, negative):
    """At HW = 3136 and a ragged HW = 667, with launch_plan_bf16's splits
    at B = 2 (so the merge runs). `one_split`: part 0's logits in the first
    split all near -1e4, so that split adds nothing; `whole_part`: part 1's
    logits all near -1e4, so each split's max alone keeps it finite."""
    rng = np.random.default_rng(11)
    b = 2
    feat, hm = bf16_inputs(rng, b, h, w)
    plan = launch_plan_bf16(b, h * w, H100_SMS)
    assert plan.n_split > 1
    if negative == "one_split":
        hm[:, 0, :plan.split_len] = bf16(hm[:, 0, :plan.split_len] - 1e4)
    elif negative == "whole_part":
        hm[:, 1] = bf16(hm[:, 1] - 1e4)
    got = emulate_bf16_attention(feat, hm, plan)
    np.testing.assert_allclose(got, gaitlab_bf16(feat, hm, h, w),
                               rtol=1e-5, atol=1e-5)


def test_three_bf16_parts_are_exact():
    """p0 + p1 + p2 == w bitwise for a million FP32 weights in (0, 1], with
    exponents down to 2^-100 and random significands, and each part is a
    bf16 value (its low 16 bits are 0)."""
    import ml_dtypes

    rng = np.random.default_rng(5)
    n = 1_000_000
    exp = rng.integers(127 - 100, 127, n).astype(np.uint32)
    bits = (exp << np.uint32(23)) | rng.integers(0, 1 << 23, n).astype(
        np.uint32)
    w = np.concatenate([bits.view(np.float32), np.float32([1.0])])
    parts = split3(w)
    for p in parts:
        assert not (p.view(np.uint32) & np.uint32(0xFFFF)).any()
    total = (parts[0] + parts[1]) + parts[2]
    np.testing.assert_array_equal(total.view(np.uint32), w.view(np.uint32))
    np.testing.assert_array_equal(
        parts[0].astype(np.float64) + parts[1] + parts[2], w)
    # the bit rounding is round to nearest even, as ml_dtypes rounds
    np.testing.assert_array_equal(
        parts[0], w.astype(ml_dtypes.bfloat16).astype(np.float32))


def test_one_bf16_part_errs_ten_times_more():
    """Against float64, the three-part kernel errs at least 10x less than
    pooling with bf16 weights (one part), on the head's shapes."""
    rng = np.random.default_rng(6)
    h = w = 56
    feat, hm = bf16_inputs(rng, 2, h, w)
    plan = launch_plan_bf16(2, h * w, H100_SMS)
    l64 = hm.astype(np.float64)
    a = np.exp(l64 - l64.max(-1, keepdims=True))
    exact = np.einsum("bjp,bcp->bjc", a / a.sum(-1, keepdims=True), feat)
    three = np.abs(emulate_bf16_attention(feat, hm, plan) - exact).max()
    one = np.abs(emulate_bf16_attention(feat, hm, plan, n_parts=1)
                 - exact).max()
    assert three * 10 < one, (three, one)


def test_subnormal_parts_change_nothing():
    """Logits 20x wider than the head's give weights down to 0, many of
    whose parts are bf16 subnormals: flushing those to zero, as the tensor
    cores may, changes no output beyond 1e-6 of the largest."""
    rng = np.random.default_rng(8)
    h, w = 23, 29
    feat, hm = bf16_inputs(rng, 2, h, w, scale=60.0)
    plan = launch_plan_bf16(2, h * w, H100_SMS)
    weights = np.exp2((hm - hm.max(-1, keepdims=True)) * LOG2E)
    parts = np.stack(split3(weights.astype(np.float32)))
    assert ((np.abs(parts) < 2.0**-126) & (parts != 0)).sum() > 100
    kept = emulate_bf16_attention(feat, hm, plan)
    flushed = emulate_bf16_attention(feat, hm, plan, flush_subnormal=True)
    assert np.abs(kept - flushed).max() <= 1e-6 * np.abs(kept).max()


PLAN_BATCHES = [1, 37, 128, 450]


@pytest.mark.parametrize("b", PLAN_BATCHES)
@pytest.mark.parametrize("hw", [56 * 56, 23 * 29, 63])
def test_bf16_plan_covers_each_position_once(b, hw):
    plan = launch_plan_bf16(b, hw, H100_SMS)
    assert plan.split_len % pt_attention.BF16_TILE == 0
    covered = np.zeros(hw, int)
    for split in range(plan.n_split):
        run = covered[split * plan.split_len:(split + 1) * plan.split_len]
        assert run.size > 0  # no empty split
        run += 1
    assert (covered == 1).all()
    assert plan.n_chunk == 1  # the head's 128 + 64 channels
    assert plan.smem <= pt_attention.MAX_SMEM
    assert plan.blocks_per_sm == 1
    assert plan.smem + pt_attention.SMEM_RESERVED <= pt_attention.SMEM_PER_SM
    if (b, hw) == (128, 56 * 56):
        assert plan.n_split == 1  # 128 blocks on 132 SMs
    if b in (1, 37) and hw == 56 * 56:
        assert plan.n_split > 1


def test_bf16_plan_chunks_channels():
    """Chunks of three 64-channel m-blocks, the features' then the cam's."""
    for c1, c2, chunks in ((128, 64, 1), (256, 64, 2), (65, 65, 2),
                           (64, 1, 1), (200, 200, 3)):
        assert launch_plan_bf16(37, 667, H100_SMS, c1, c2).n_chunk == chunks


def test_bf16_plan_matches_the_kernel():
    """The Python plan's tiles and shared memory are the kernel's: the
    kernel refuses a plan whose shared memory is not its kSmemBytes."""
    src = open(osp.join(_build.SRC_DIR, "keypoint_attention_bf16.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kTile") == pt_attention.BF16_TILE
    assert const("kRows") == pt_attention.BF16_ROWS
    assert const("kMB") == pt_attention.BF16_MBLOCKS
    assert const("kStages") == pt_attention.BF16_STAGES
    assert const("kJ") == pt_attention.KERNEL_PARTS
    j, tile, rows, mb = 24, 64, 64, 3
    stage = mb * rows * tile * 2 + j * tile * 2 + 3 * j * tile * 2
    smem = const("kStages") * stage + 2 * const("kStages") * 8 + 2 * j * 4 \
        + 1024
    assert pt_attention.BF16_STAGE_BYTES == stage
    assert pt_attention.BF16_SMEM == smem
    assert "gaitlab_keypoint_attention_bf16" in src
    assert _build.SIGNATURES["keypoint_attention_bf16"][0] in src


def bf16_zeros(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_tma_strides_of_the_heads_views():
    """The head's NCHW views (the logits' background channel sliced off)
    are read as they lie, in (batch, channel) strides."""
    f = bf16_zeros(2, 128, 56, 56).permute(0, 2, 3, 1)
    hm = bf16_zeros(2, 25, 56, 56)[:, 1:].permute(0, 2, 3, 1)
    assert pt_attention.tma_strides(f) == (128 * 3136, 3136)
    assert pt_attention.tma_strides(hm) == (25 * 3136, 3136)
    # one frame: its stride is never followed
    one = torch.as_strided(bf16_zeros(64 * 3136 + 3), (1, 56, 56, 64),
                           (64 * 3136 + 3, 56, 1, 3136))
    assert pt_attention.tma_strides(one) == (64 * 3136, 3136)


@pytest.mark.parametrize("case", ["nhwc", "ragged_nchw", "offset",
                                  "rows_apart", "batch_inside"])
def test_tma_strides_refuse_what_must_be_copied(case):
    """Positions not contiguous (NHWC), a channel stride of H*W = 63 (not
    16-byte aligned), a pointer 2 bytes off, rows padded apart (positions
    not on one stride), and frames nested inside channels."""
    x = {"nhwc": lambda: bf16_zeros(2, 7, 9, 24),
         "ragged_nchw": lambda: bf16_zeros(2, 24, 7, 9).permute(0, 2, 3, 1),
         "offset": lambda: bf16_zeros(2 * 24 * 64 + 1)[1:].view(
             2, 24, 8, 8).permute(0, 2, 3, 1),
         "rows_apart": lambda: bf16_zeros(2, 24, 8, 16)[..., :8].permute(
             0, 2, 3, 1),
         "batch_inside": lambda: bf16_zeros(24, 2, 8, 8).permute(1, 2, 3, 0),
         }[case]()
    assert pt_attention.tma_strides(x) is None


@pytest.mark.parametrize("h,w", [(7, 9), (8, 8), (1, 5)])
def test_nchw_copy_pads_positions_to_16_bytes(h, w):
    x = torch.randn(3, h, w, 24).to(torch.bfloat16)
    y = pt_attention.nchw_copy(x)
    hwp = -(-h * w // 8) * 8
    assert torch.equal(y, x)
    assert y.stride() == (24 * hwp, w, 1, hwp)
    assert pt_attention.tma_strides(y) == (24 * hwp, hwp)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def head_views(g, b, cuda, scale=3.0):
    """The head's bf16 layout: NCHW tensors as NHWC views, the logits'
    background channel sliced off."""
    bf = torch.bfloat16
    f = torch.randn(b, 128, 56, 56, device=cuda, generator=g).relu().to(bf)
    c = torch.randn(b, 64, 56, 56, device=cuda, generator=g).to(bf)
    hm = (torch.randn(b, 25, 56, 56, device=cuda, generator=g)
          * scale).to(bf)
    return (f.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1),
            hm[:, 1:].permute(0, 2, 3, 1))


def check_against_plain(args, copies: int):
    n = (keypoint_attention_fused.launches_bf16,
         keypoint_attention_fused.copies_bf16)
    got = keypoint_attention_fused(*args)
    torch.cuda.synchronize()
    assert (keypoint_attention_fused.launches_bf16,
            keypoint_attention_fused.copies_bf16) == (n[0] + 1, n[1] + copies)
    want = keypoint_attention_plain(*args)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("b", PLAN_BATCHES)
def test_bf16_kernel_on_head_views_on_card(cuda, b):
    g = torch.Generator(device=cuda).manual_seed(b)
    check_against_plain(head_views(g, b, cuda), copies=0)


@pytest.mark.gpu
def test_bf16_kernel_on_tiny_weights_on_card(cuda):
    """Logits 20x wider than the head's: weights whose parts are bf16
    subnormals or 0."""
    g = torch.Generator(device=cuda).manual_seed(3)
    check_against_plain(head_views(g, 37, cuda, scale=60.0), copies=0)


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(7, 9), (23, 29)])
def test_bf16_kernel_on_nhwc_on_card(cuda, h, w):
    """Contiguous NHWC with a ragged H*W: the wrapper copies all three into
    the head's layout, once per call."""
    g = torch.Generator(device=cuda).manual_seed(h * w)
    args = tuple((torch.randn(5, h, w, ch, device=cuda, generator=g)
                  * s).to(torch.bfloat16)
                 for ch, s in ((128, 1), (64, 1), (24, 3)))
    check_against_plain(args, copies=1)
