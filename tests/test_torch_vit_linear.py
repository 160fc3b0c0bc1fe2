"""The ViT blocks' linears on the tensor cores: csrc/vit_linear.cu through
the op gaitlab::vit_linear_f32 (ops/vit_linear.py).

On the CPU: the plain version's split arithmetic (three TF32 passes over
TF32-exact parts) against a float64 product errs at most twice as much as
F.linear in float32 at the ViT's depths K = 1280 and 5120, where one TF32
pass errs about a thousand times more; `launch_plan` covers the output
once at every bucket and within the card's shared memory and SMs, and
agrees with the kernel's constants; the routing: only a float32 tensor on
the card in a full-float32 segment reaches the op, so "default", "high",
a bf16 trunk, the decoder's and GRNet's layers and CPU tensors never do
(a tensor subclass that calls itself a CUDA tensor stands for the card);
the weight's low part is kept per tensor and split again when the weight
changes. On a card (tests marked `gpu`, skipped without one): the kernel
against the plain version and float64 at ragged and bucket shapes:

    python -m pytest --noconftest -m gpu tests/test_torch_vit_linear.py

Tolerances: the kernel against the plain version 1e-5 of max|y| (the same
TF32-exact products, FP32 sums in another order).
"""

import copy
import math
import os.path as osp
import re

import pytest
import torch
import torch.nn.functional as F

from gaitlab_torch.nn import vit as pt_vit
from gaitlab_torch.nn.hmr2 import HMR2Core
from gaitlab_torch.nn.layers import Linear, precision_scope
from gaitlab_torch.ops import _build
from gaitlab_torch.ops import vit_linear as vl
from torch_threads import torch_threads  # noqa: F401

H100_SMS = 132
# the four products of a ViT-H block: (N, K)
VIT_SHAPES = {"qkv": (3840, 1280), "proj": (1280, 1280),
              "fc1": (5120, 1280), "fc2": (1280, 5120)}
TOKENS = 192
BUCKETS = (32, 64, 128, 256, 450)
RAGGED = (1, 37)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    return torch.device("cuda")


class CardLike(torch.Tensor):
    """A CPU tensor that calls itself a CUDA tensor, so that the layers'
    routing takes the card's branch; the op then runs its CPU kernel."""

    @property
    def is_cuda(self):
        return True


def operands(k: int, n: int, rows: int = TOKENS, seed: int = 0):
    """LayerNorm-scale activations (after GELU for fc2's depth) and ViT-
    scale weights (std 0.02) and bias."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, k, generator=g)
    if k == 5120:
        x = F.gelu(x)
    return (x, torch.randn(n, k, generator=g) * 0.02,
            torch.randn(n, generator=g) * 0.02)


def rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    """||y - ref|| / ||ref||, ref in float64."""
    return ((y.double() - ref).norm() / ref.norm()).item()


@pytest.mark.parametrize("k,n", [(1280, 256), (5120, 128)])
def test_split_arithmetic_is_float32(k, n):
    """Three TF32 passes over the split parts err at most twice as much as
    F.linear in float32 against float64; one TF32 pass misses that bar."""
    x, w, b = operands(k, n)
    ref = F.linear(x.double(), w.double(), b.double())
    f32 = rel_err(F.linear(x, w, b), ref)
    split = rel_err(vl.vit_linear_plain(x, w, b), ref)
    one_pass = rel_err(F.linear(vl.tf32_rna(x), vl.tf32_trunc(w), b), ref)
    assert split <= 2 * f32
    assert one_pass > 2 * f32


def test_parts_are_tf32_and_sum_to_the_value():
    """Each part keeps 11 significant bits (the low 13 bits of its float32
    are zero), and hi + lo is the value to about 2^-21 of it, for x's
    rounded split and W's truncated one alike."""
    x, w, _ = operands(1280, 128)
    for (hi, lo), a in ((vl.split_x(x), x), (vl.split_w(w), w)):
        for part in (hi, lo):
            assert not (part.view(torch.int32) & 8191).any()
        assert ((hi + lo - a).abs() <= a.abs() * 2.0 ** -21).all()


def test_tf32_rna_rounds_to_nearest_ties_away():
    """cvt.rna.tf32.f32 on bit patterns: below half an ulp down, a tie and
    above it up (away from zero for either sign)."""
    base = 0x3F800000  # 1.0
    bits = torch.tensor([base | 0x0FFF, base | 0x1000, base | 0x1001,
                         base | 0x2000], dtype=torch.int32)
    for sign in (1, -1):
        vals = bits.view(torch.float32) * sign
        got = vl.tf32_rna(vals).view(torch.int32) & 0x7FFFFFFF
        want = torch.tensor([base, base | 0x2000, base | 0x2000,
                             base | 0x2000], dtype=torch.int32)
        assert torch.equal(got, want)


@pytest.mark.parametrize("rows", BUCKETS + RAGGED)
@pytest.mark.parametrize("name", sorted(VIT_SHAPES))
def test_plan_covers_the_output_once(rows, name):
    """At every bucket and ragged M = rows x 192: the walk's tiles cover
    every 128 x 128 output tile once; shared memory and the persistent grid
    fit an H100."""
    n, k = VIT_SHAPES[name]
    m = rows * TOKENS
    plan = vl.launch_plan(m, n, k, H100_SMS)
    n_m, n_n = math.ceil(m / vl.BM), n // vl.BM
    assert plan.tiles == n_m * n_n
    seen = {vl.tile_coords(t, n_m, n_n, plan.group)
            for t in range(plan.tiles)}
    assert seen == {(i, j) for i in range(n_m) for j in range(n_n)}
    assert plan.smem <= 232_448  # a Hopper block's dynamic shared memory
    assert plan.grid == min(plan.tiles, H100_SMS) <= 132


@pytest.mark.parametrize("n,k", [(1280, 1000), (1000, 1280), (0, 128)])
def test_plan_refuses_unaligned_widths(n, k):
    with pytest.raises(ValueError):
        vl.launch_plan(TOKENS, n, k, H100_SMS)


def test_plan_matches_the_kernel():
    """The Python plan's tiles and shared memory are the kernel's: the
    kernel refuses a plan whose shared memory is not its kSmemBytes."""
    src = open(osp.join(_build.SRC_DIR, "vit_linear.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kBM") == const("kBN") == vl.BM
    assert const("kBK") == vl.BK
    assert const("kStages") == vl.STAGES
    stage = 3 * vl.BM * vl.BK * 4
    assert vl.STAGE_BYTES == stage
    assert vl.SMEM_BYTES == const("kStages") * stage + 2 * vl.STAGES * 8 \
        + 1024
    assert _build.SIGNATURES["vit_linear"][0] in src


def tiny_core() -> HMR2Core:
    torch.manual_seed(0)
    return HMR2Core(img_res=64, width=128, depth=2, heads=2, mlp=256,
                    dec_width=64, dec_depth=1, dec_heads=2, dec_head_dim=32,
                    dec_mlp=64).eval()


def op_calls(monkeypatch) -> list:
    """Record every call that reaches the op's CPU kernel."""
    calls = []
    plain = vl.vit_linear_plain

    def spy(x, weight, bias):
        calls.append(tuple(weight.shape))
        return plain(x, weight, bias)

    monkeypatch.setattr(vl, "vit_linear_plain", spy)
    return calls


def test_only_the_blocks_linears_reach_the_op(monkeypatch):
    """On the card's branch at "float32": the four linears of every block
    and nothing else, the decoder's `Linear`s included; no launch is
    counted on the CPU kernel."""
    calls = op_calls(monkeypatch)
    core = tiny_core()
    x = torch.randn(3, 3, 64, 64)
    launches = vl.vit_linear_f32.launches
    with torch.no_grad():
        want = core(x)
        got = core(x.as_subclass(CardLike))
    width, mlp = 128, 256
    assert calls == [(3 * width, width), (width, width), (mlp, width),
                     (width, mlp)] * 2
    assert vl.vit_linear_f32.launches == launches
    for key in want:  # the split's 2^-21 against one product: the
        # tolerance of the HMR 2.0 tests against their reference
        got_k = got[key].as_subclass(torch.Tensor)
        assert (got_k - want[key]).abs().max() <= \
            1e-5 * want[key].abs().max()
    blocks = {n for n, m in core.named_modules()
              if isinstance(m, pt_vit.BlockLinear)}
    assert blocks == {f"backbone.blocks.{i}.{layer}" for i in range(2)
                      for layer in ("attn.qkv", "attn.proj", "mlp.fc1",
                                    "mlp.fc2")}


@pytest.mark.parametrize("mode", ["default", "high", "bf16"])
def test_other_modes_never_reach_the_op(monkeypatch, mode):
    """"default" keeps cuBLAS's one TF32 pass, "high" the bf16-masked
    passes, a bf16 trunk cuBLAS's bf16 products."""
    calls = op_calls(monkeypatch)
    core = tiny_core()
    x = torch.randn(2, 3, 64, 64)
    if mode == "bf16":
        core, x = copy.deepcopy(core).to(torch.bfloat16), x.bfloat16()
    else:
        core = core.at_modes(mode, None)
    with torch.no_grad():
        core(x.as_subclass(CardLike))
    assert calls == []


def test_cpu_tensors_take_linear(monkeypatch):
    """A CPU tensor in a float32 segment: `Linear`'s one product, bit for
    bit, without the op."""
    calls = op_calls(monkeypatch)
    layer = pt_vit.BlockLinear(128, 256)
    x = torch.randn(5, 7, 128)
    with precision_scope("float32"):
        got = layer(x)
    assert calls == []
    assert torch.equal(got, F.linear(x, layer.weight, layer.bias))


def test_grnet_has_no_block_linear():
    """GRNet's PARE head and MAX-GRNet's corrector keep `Linear` (the ops'
    only caller is BlockLinear, a ViT block's)."""
    from gaitlab_torch.nn.grnet import GRNet

    model = GRNet.create(device="cpu", backbone_width=8,
                         num_input_features=120, num_features_pare=32,
                         num_features_smpl=16, backbone_modules=(1, 1, 1),
                         backbone_blocks=1, use_gait_feat=True,
                         featcorr_h_size=64)
    layers = list(model.module.modules())
    assert any(isinstance(m, Linear) for m in layers)
    assert not any(isinstance(m, pt_vit.BlockLinear) for m in layers)


def test_weight_lo_is_kept_and_split_again_after_an_edit():
    w = torch.randn(256, 128) * 0.02
    lo = vl.weight_lo(w)
    assert vl.weight_lo(w) is lo
    assert torch.equal(lo, vl.split_w(w)[1])
    w.mul_(1.5)  # moves _version
    lo2 = vl.weight_lo(w)
    assert lo2 is not lo and torch.equal(lo2, vl.split_w(w)[1])
    w.data = torch.randn(256, 128)  # new data, same tensor
    assert torch.equal(vl.weight_lo(w), vl.split_w(w)[1])


def test_op_schema_fake_and_autograd():
    """The op's fake implementation (for torch.export and the serving
    programs) and its backward, checked by torch.library.opcheck; for a
    loss linear in y, the backward's gradients are F.linear's."""
    x, w, b = operands(128, 256, rows=6)
    x, w, b = (t.requires_grad_() for t in (x, w, b))
    torch.library.opcheck(torch.ops.gaitlab.vit_linear_f32.default,
                          (x, w, b))
    c = torch.randn(6, 256, generator=torch.Generator().manual_seed(1))
    n0 = vl.vit_linear_f32.backwards
    (vl.vit_linear_f32(x, w, b) * c).sum().backward()
    assert vl.vit_linear_f32.backwards == n0 + 1
    grads = [t.grad.clone() for t in (x, w, b)]
    for t in (x, w, b):
        t.grad = None
    (F.linear(x, w, b) * c).sum().backward()
    for got, t in zip(grads, (x, w, b)):
        torch.testing.assert_close(got, t.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 37, 32])
@pytest.mark.parametrize("name", sorted(VIT_SHAPES))
def test_kernel_on_card(cuda, rows, name):
    """The kernel against the plain version on the card (TF32 off) and
    both against float64: within twice cuBLAS SGEMM's error."""
    n, k = VIT_SHAPES[name]
    x, w, b = (t.to(cuda) for t in operands(k, n, rows * TOKENS, rows))
    n0 = vl.vit_linear_f32.launches
    got = vl.vit_linear_f32(x, w, b)
    torch.cuda.synchronize()
    assert vl.vit_linear_f32.launches == n0 + 1
    want = vl.vit_linear_plain(x, w, b)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
    ref = F.linear(x.double(), w.double(), b.double())
    assert rel_err(got, ref) <= 2 * rel_err(F.linear(x, w, b), ref)
