"""SMPL's counts, shared by every architecture that regresses SMPL
through kernel B2 (body/smpl.py, csrc/blendshapes.cu): B2's FLOPs and
least bytes, and SMPL's products around it."""

from __future__ import annotations

SMPL_JOINTS = 24
PROJECTED_JOINTS = 29  # the spin2 joint set


def b2_work(rows: int, verts: int, betas: int, pose: int) -> tuple:
    """(FLOPs, bytes) of B2: v_template + shapedirs.betas +
    posedirs^T.pose_feature over R = 3V rows; inputs read once, the
    (rows,V,3) output written once."""
    r = 3 * verts
    flops = 2 * rows * r * (betas + pose) + rows * r
    nbytes = 4 * (r + r * betas + pose * r + rows * (betas + pose) + rows * r)
    return flops, nbytes


def smpl_products(rows: int, verts: int, betas: int) -> float:
    """SMPL's products around B2 for `rows` frames: the joint regressor on
    the template and through the shape blendshapes, skinning's W.A and the
    per-vertex transform, the extra joints and their projection."""
    j = SMPL_JOINTS
    return (2 * j * verts * 3 * (1 + betas) + 2 * rows * verts * (j * 16 + 9 + 3)
            + 2 * rows * PROJECTED_JOINTS * 9)
