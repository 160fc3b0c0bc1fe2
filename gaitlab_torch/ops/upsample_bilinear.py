"""Bilinear resize of NCHW tensors with align_corners=True.

The CUDA kernel (csrc/upsample_bilinear.cu) takes the place of ATen's NCHW
`upsample_bilinear2d` in the backbone's upsampling head (six 2x resizes a
forward) and in its other heads; it replaces no TPU kernel (gaitlab
resizes with two interpolation matmuls under XLA). It is bound by its
bytes (8.78 MB a row over the head's six resizes in float32, about 0.34 ms
at B = 128 on an H100) and computes ATen's arithmetic, so float32 results
equal ATen's bit for bit; bfloat16 and float16 are read and written as
they are and interpolated in float. `launch_plan` tiles the planes.

The wrapper calls the custom op `gaitlab::upsample_bilinear_ac`, whose
CUDA implementation is the kernel and whose CPU implementation is
`F.interpolate` (the plain version), so the device of the input picks one
when the op runs: in eager code and inside a `torch.export` program alike
(`serve.py`). Its backward is ATen's `upsample_bilinear2d_backward` on
either device (gaitlab has no backward kernel).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from gaitlab_torch.ops import _build

MAX_THREADS = 256        # kMaxThreads of csrc/upsample_bilinear.cu
TILE_VECS = 2048         # output vectors a block writes, about 8 a thread
MAX_SMEM = 227 * 1024    # dynamic shared memory a block may have on Hopper
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class UpsamplePlan(NamedTuple):
    vec: int         # outputs of a row written by one store
    plane_tile: int  # planes a block resizes (1 where rows are split)
    row_tile: int    # output rows of each plane a block writes
    block: tuple     # (threads over a row's vectors, threads over rows)
    grid: int        # blocks: plane groups x row chunks
    cap: int         # input rows of each plane a block stages
    smem: int        # dynamic shared memory per block, bytes


def rows_cap(in_h: int, out_h: int, row_tile: int) -> int:
    """Input rows a block of `row_tile` output rows stages: the whole plane
    where the block holds whole planes, else the rows its taps reach from
    the exact scale, plus one for the second tap and two for the float
    scale's rounding."""
    if row_tile >= out_h:
        return in_h
    span = -(-(in_h - 1) * (row_tile - 1) // (out_h - 1))
    return min(in_h, span + 3)


def smem_bytes(plane_tile: int, row_tile: int, cap: int, in_w: int,
               elt: int) -> int:
    """The staged input rows (rounded up to 16 bytes), then each output
    row's (top, bottom) offsets and (l0, l1) weights, 16 bytes a row."""
    return (-(-plane_tile * cap * in_w * elt // 16) * 16
            + 16 * plane_tile * row_tile)


@functools.lru_cache(maxsize=256)
def launch_plan(planes: int, in_h: int, in_w: int, out_h: int, out_w: int,
                elt: int = 4, align: int = 16) -> UpsamplePlan:
    """How the kernel resizes `planes` (in_h, in_w) planes of `elt`-byte
    values to (out_h, out_w), where `align` is the output's byte alignment.
    A store writes the widest vector of at most 16 bytes that divides a
    row. A block writes about TILE_VECS vectors: whole planes where one
    plane has fewer (a multiple of the planes that keep its input 16-byte
    aligned, where that many fit), else a chunk of rows of one plane.
    Planes, then rows, are halved until the staged input fits in shared
    memory. Threads: one per vector of a row (at most MAX_THREADS), and as
    many over rows as fill MAX_THREADS, evened out over the passes."""
    vec = next(v for v in (8, 4, 2, 1) if v * elt <= 16 and out_w % v == 0
               and align % (v * elt) == 0)
    n_vec = out_w // vec
    if out_h * n_vec <= TILE_VECS:
        row_tile = out_h
        plane_tile = max(1, min(planes, TILE_VECS // (out_h * n_vec)))
        period = 16 // math.gcd(16, in_h * in_w * elt)
        if plane_tile >= period:
            plane_tile -= plane_tile % period
    else:
        plane_tile, row_tile = 1, max(1, TILE_VECS // n_vec)
    while smem_bytes(plane_tile, row_tile, rows_cap(in_h, out_h, row_tile),
                     in_w, elt) > MAX_SMEM:
        if plane_tile > 1:
            plane_tile //= 2
        elif row_tile > 1:
            row_tile //= 2
        else:
            raise ValueError(f"upsample_bilinear: input rows of {in_w} "
                             f"values do not fit in shared memory")
    bx = min(n_vec, MAX_THREADS)
    tile_rows = plane_tile * row_tile
    passes = -(-tile_rows // max(1, MAX_THREADS // bx))
    by = -(-tile_rows // passes)
    grid = -(-planes // plane_tile) * -(-out_h // row_tile)
    if grid >= 2**31:
        raise ValueError(f"upsample_bilinear: {grid} blocks")
    cap = rows_cap(in_h, out_h, row_tile)
    return UpsamplePlan(vec, plane_tile, row_tile, (bx, by), grid, cap,
                        smem_bytes(plane_tile, row_tile, cap, in_w, elt))


def upsample_bilinear_plain(x: torch.Tensor, out_h: int, out_w: int
                            ) -> torch.Tensor:
    """Plain PyTorch version: ATen's bilinear resize, align_corners=True."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def upsample_bilinear_ac(x: torch.Tensor, out_h: int, out_w: int
                         ) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, out_h, out_w), bilinear with align_corners,
    up or down, in x's dtype.

    On a CUDA tensor this launches the kernel (or raises); on a CPU
    tensor it runs `upsample_bilinear_plain`. Either way through the
    custom op `torch.ops.gaitlab.upsample_bilinear_ac`."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError("upsample_bilinear: the input must be on the CPU or "
                         f"on a CUDA device (got {x.device})")
    return torch.ops.gaitlab.upsample_bilinear_ac(x, out_h, out_w)


upsample_bilinear_ac.launches = 0
upsample_bilinear_ac.backwards = 0


def _launch(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The op's CUDA implementation: checks, plan, one launch; counts it."""
    if x.device.type != "cuda":
        raise ValueError("upsample_bilinear: the input must be on a CUDA "
                         f"device (got {x.device})")
    if x.dtype not in DTYPES:
        raise ValueError(f"upsample_bilinear: dtype {x.dtype}; the kernel "
                         "takes float32, bfloat16 or float16")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("upsample_bilinear: the input must be a contiguous "
                         f"NCHW tensor (got shape {tuple(x.shape)}, strides "
                         f"{x.stride()})")
    n, c, h, w = x.shape
    if min(h, w, out_h, out_w) <= 0:
        raise ValueError(f"upsample_bilinear: sizes {(h, w)} -> "
                         f"{(out_h, out_w)} must be positive")
    out = torch.empty((n, c, out_h, out_w), device=x.device, dtype=x.dtype)
    if n * c == 0:
        return out
    ptr = out.data_ptr()
    plan = launch_plan(n * c, h, w, out_h, out_w, x.element_size(),
                       min(16, ptr & -ptr))
    lib = _build.library("upsample_bilinear")
    dev = x.device
    with torch.cuda.device(dev):
        code = lib.gaitlab_upsample_bilinear(
            x.data_ptr(), ptr, DTYPES[x.dtype], n * c, h, w, out_h, out_w,
            plan.vec, plan.plane_tile, plan.row_tile, *plan.block, plan.grid,
            plan.cap, plan.smem, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "upsample_bilinear")
    _build.count(upsample_bilinear_ac)
    return out


@torch.library.custom_op("gaitlab::upsample_bilinear_ac", mutates_args=(),
                         device_types="cuda")
def _op(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    return _launch(x, out_h, out_w)


@_op.register_kernel("cpu")
def _op_cpu(x, out_h, out_w):
    return upsample_bilinear_plain(x, out_h, out_w)


@_op.register_fake
def _op_fake(x, out_h, out_w):
    return x.new_empty((x.shape[0], x.shape[1], out_h, out_w))


def _setup_backward(ctx, inputs, output):
    x, out_h, out_w = inputs
    ctx.in_size = tuple(x.shape)
    ctx.out_size = (out_h, out_w)


def _backward(ctx, d_out):
    """ATen's backward of the same resize: each output's gradient spread
    over its four taps with the forward's weights. Counts one backward."""
    d_x = torch.ops.aten.upsample_bilinear2d_backward(
        d_out, list(ctx.out_size), list(ctx.in_size), True)
    _build.count(upsample_bilinear_ac, "backwards")
    return d_x, None, None


_op.register_autograd(_backward, setup_context=_setup_backward)
