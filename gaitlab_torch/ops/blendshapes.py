"""Fused SMPL blendshapes: v_template + shapedirs.beta + posedirs.pose.

The CUDA kernel (csrc/blendshapes.cu) replaces the Pallas TPU kernel
gaitlab/ops/lbs_pallas.py::blendshapes. It multiplies on the tensor cores
in 3xTF32 (each factor split into two TF32 parts, three products summed in
FP32), which keeps float32 accuracy; on an H100 it is then bound by its
28 MB of traffic (about 8.4 us at B = 128). The source note says how.
`launch_plan` sizes its grid and shared memory.

The wrapper calls the custom op `gaitlab::blendshapes`, whose CUDA
implementation is the kernel and whose CPU implementation is the plain
version, so the device of the inputs picks one when the op runs: in eager
code and inside a `torch.export` program alike (`serve.py`). Its backward
is plain torch code on either device (gaitlab's Pallas kernel has none:
gaitlab trains through XLA's autodiff of the plain sum), so a training
step runs the kernel forward.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaitlab_torch.ops import _build

# the tiles of csrc/blendshapes.cu
ROW_TILE = 160     # kRowTile: vertex rows per block
BATCH_TILE = 128   # kBatchTile: batch columns per block
CHUNK = 16         # kChunk: rows of K per pipeline stage
STAGES = 4         # kStages
DIR_STRIDE = ROW_TILE + 8  # kDirStride: padded dirs rows in a stage
OUT_STRIDE = ROW_TILE + 8  # kOutStride: the output tile staged at the end
MAX_SMEM = 227 * 1024  # dynamic shared memory a block may have on Hopper


class BlendshapesPlan(NamedTuple):
    grid: tuple      # (row tiles, batch tiles)
    smem: int        # dynamic shared memory per block, bytes
    vec: int         # floats per cp.async copy of a posedirs row


def launch_plan(n_batch: int, rows: int, n_shape: int, n_pose: int,
                align: int = 16) -> BlendshapesPlan:
    """Grid, shared memory and copy width of the kernel for `rows` = V*3
    rows, where `align` is the byte alignment that posedirs and the output
    share. Shared memory holds the cp.async ring of dirs (STAGES x CHUNK
    rows of DIR_STRIDE floats) and the block's BATCH_TILE rows of betas and
    of pose features, each rounded up to whole 16-byte groups; at the end
    the same memory stages the block's output tile."""
    def r4(n):
        return -(-n // 4) * 4

    smem = 4 * max(STAGES * CHUNK * DIR_STRIDE + r4(BATCH_TILE * n_shape)
                   + r4(BATCH_TILE * n_pose), BATCH_TILE * OUT_STRIDE)
    if smem > MAX_SMEM:
        raise ValueError(f"blendshapes: {n_shape} + {n_pose} coefficients "
                         f"need {smem} bytes of shared memory per block")
    vec = next(v for v in (4, 2, 1) if rows % v == 0 and align % (4 * v) == 0)
    return BlendshapesPlan((-(-rows // ROW_TILE), -(-n_batch // BATCH_TILE)),
                           smem, vec)


def blendshapes_plain(v_template: torch.Tensor, shapedirs: torch.Tensor,
                      posedirs: torch.Tensor, betas: torch.Tensor,
                      pose_feature: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `blendshapes`, in the same layouts."""
    v = v_template.shape[0]
    b = betas.shape[0]
    shaped = torch.einsum("vds,bs->bvd", shapedirs, betas)
    posed = torch.einsum("pr,bp->br", posedirs, pose_feature).reshape(b, v, 3)
    return v_template[None] + shaped + posed


def blendshapes(v_template: torch.Tensor, shapedirs: torch.Tensor,
                posedirs: torch.Tensor, betas: torch.Tensor,
                pose_feature: torch.Tensor) -> torch.Tensor:
    """(V,3) + (V,3,S).(B,S) + (P,V*3).(B,P) -> (B,V,3) float32.

    On CUDA tensors this launches the kernel (or raises); on CPU tensors
    it runs `blendshapes_plain`. Either way through the custom op
    `torch.ops.gaitlab.blendshapes`."""
    args = (v_template, shapedirs, posedirs, betas, pose_feature)
    if not all(a.device.type == "cpu" for a in args):
        dev = v_template.device
        if dev.type != "cuda" or any(a.device != dev for a in args):
            raise ValueError("blendshapes: all inputs must be on one CUDA "
                             f"device (got {[str(a.device) for a in args]})")
    return torch.ops.gaitlab.blendshapes(*args)


blendshapes.launches = 0
blendshapes.backwards = 0


def _launch(v_template: torch.Tensor, shapedirs: torch.Tensor,
            posedirs: torch.Tensor, betas: torch.Tensor,
            pose_feature: torch.Tensor) -> torch.Tensor:
    """The op's CUDA implementation: checks, plan, one launch; counts it."""
    args = (v_template, shapedirs, posedirs, betas, pose_feature)
    dev = v_template.device
    if dev.type != "cuda" or any(a.device != dev for a in args):
        raise ValueError("blendshapes: all inputs must be on one CUDA device "
                         f"(got {[str(a.device) for a in args]})")
    if any(a.dtype != torch.float32 or not a.is_contiguous() for a in args):
        raise ValueError("blendshapes: inputs must be contiguous float32")
    v = v_template.shape[0]
    b, s = betas.shape
    p = pose_feature.shape[1]
    if (v_template.shape != (v, 3) or shapedirs.shape != (v, 3, s)
            or posedirs.shape != (p, v * 3) or pose_feature.shape != (b, p)):
        raise ValueError(
            "blendshapes: shapes "
            f"{[tuple(a.shape) for a in args]} do not match "
            "(V,3), (V,3,S), (P,V*3), (B,S), (B,P)")
    out = torch.empty((b, v, 3), device=dev, dtype=torch.float32)
    if b == 0:
        return out
    ptrs = posedirs.data_ptr() | out.data_ptr()
    plan = launch_plan(b, v * 3, s, p, align=ptrs & -ptrs)
    lib = _build.library("blendshapes")
    with torch.cuda.device(dev):
        code = lib.gaitlab_blendshapes(
            v_template.data_ptr(), shapedirs.data_ptr(), posedirs.data_ptr(),
            betas.data_ptr(), pose_feature.data_ptr(), out.data_ptr(),
            v * 3, b, s, p, *plan.grid, plan.smem, plan.vec,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "blendshapes")
    blendshapes.launches += 1
    return out


@torch.library.custom_op("gaitlab::blendshapes", mutates_args=(),
                         device_types="cuda")
def _op(v_template: torch.Tensor, shapedirs: torch.Tensor,
        posedirs: torch.Tensor, betas: torch.Tensor,
        pose_feature: torch.Tensor) -> torch.Tensor:
    return _launch(v_template, shapedirs, posedirs, betas, pose_feature)


@_op.register_kernel("cpu")
def _op_cpu(v_template, shapedirs, posedirs, betas, pose_feature):
    return blendshapes_plain(v_template, shapedirs, posedirs, betas,
                             pose_feature)


@_op.register_fake
def _op_fake(v_template, shapedirs, posedirs, betas, pose_feature):
    return v_template.new_empty((betas.shape[0],) + tuple(v_template.shape))


def _setup_backward(ctx, inputs, output):
    _, shapedirs, posedirs, betas, pose_feature = inputs
    ctx.save_for_backward(shapedirs, posedirs, betas, pose_feature)


def _backward(ctx, dv):
    """Gradients of the sum (B,V,3): the coefficients get dv contracted
    with their directions, v_template the batch sum of dv, and the
    directions (only where asked for) dv contracted with their
    coefficients. Counts one backward."""
    shapedirs, posedirs, betas, pose_feature = ctx.saved_tensors
    need = ctx.needs_input_grad
    b = dv.shape[0]
    dv_rows = dv.reshape(b, -1)  # (B, V*3)
    grads = [
        dv.sum(0) if need[0] else None,
        torch.einsum("bvk,bs->vks", dv, betas) if need[1] else None,
        pose_feature.T @ dv_rows if need[2] else None,
        torch.einsum("bvk,vks->bs", dv, shapedirs) if need[3] else None,
        dv_rows @ posedirs.T if need[4] else None,
    ]
    blendshapes.backwards += 1
    return tuple(grads)


_op.register_autograd(_backward, setup_context=_setup_backward)
