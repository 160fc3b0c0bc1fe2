"""Rotation representations and camera models on torch tensors.

Counterpart of gaitlab/core/geometry.py, ported from it (not from the
reference's torch geometry) so that the eps and NaN conventions agree:
  * quaternions are (w, x, y, z)
  * `rot6d_to_rotmat` normalises with eps=1e-6, `rot6d_to_rotmat_spin`
    with the F.normalize default eps=1e-12
  * `rotmat_to_quat` is the branch-free 4-case Shepperd selection, and
    `rotmat_to_axis_angle` zeroes NaNs
All functions are batched over leading dimensions.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _normalize(x: Tensor, dim: int = -1, eps: float = 1e-12) -> Tensor:
    """torch.nn.functional.normalize semantics: x / max(||x||, eps)."""
    return x / torch.linalg.norm(x, dim=dim, keepdim=True).clamp_min(eps)


# ---------------------------------------------------------------------------
# quaternions
# ---------------------------------------------------------------------------

def quat_to_rotmat(quat: Tensor) -> Tensor:
    """(N,4) wxyz quaternion -> (N,3,3)."""
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=-1,
    )
    return m.reshape(quat.shape[:-1] + (3, 3))


def axis_angle_to_quat(axisang: Tensor) -> Tensor:
    """(N,3) axis-angle -> (N,4) wxyz unit quaternion; the norm is taken of
    (axisang + 1e-8) and the unshifted vector is divided by it."""
    angle = torch.linalg.norm(axisang + 1e-8, dim=-1, keepdim=True)
    axis = axisang / angle
    half = angle * 0.5
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def quat_to_axis_angle(quaternion: Tensor) -> Tensor:
    """(...,4) wxyz quaternion -> (...,3) axis-angle."""
    q1, q2, q3 = quaternion[..., 1], quaternion[..., 2], quaternion[..., 3]
    sin_sq = q1 * q1 + q2 * q2 + q3 * q3
    sin_theta = torch.sqrt(sin_sq)
    cos_theta = quaternion[..., 0]
    two_theta = 2.0 * torch.where(
        cos_theta < 0.0,
        torch.atan2(-sin_theta, -cos_theta),
        torch.atan2(sin_theta, cos_theta),
    )
    # both branches of where() are evaluated: guard the division by 0
    k_pos = two_theta / torch.where(sin_theta > 0.0, sin_theta,
                                    torch.ones_like(sin_theta))
    k = torch.where(sin_sq > 0.0, k_pos, 2.0 * torch.ones_like(sin_theta))
    return torch.stack([q1 * k, q2 * k, q3 * k], dim=-1)


def qrot(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vectors v (*,3) by quaternions q (*,4)."""
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v)
    uuv = torch.linalg.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qmul(q: Tensor, r: Tensor) -> Tensor:
    """Quaternion product q*r, both (*,4) wxyz."""
    w1, x1, y1, z1 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def qfix(q: Tensor) -> Tensor:
    """Enforce quaternion sign continuity along axis 0 of q (L, J, 4)."""
    dots = torch.sum(q[1:] * q[:-1], dim=-1)  # (L-1, J)
    flip = torch.cumsum((dots < 0).to(torch.int64), dim=0) % 2 == 1
    sign = torch.where(flip, -1.0, 1.0).to(q.dtype)[..., None]
    return torch.cat([q[:1], q[1:] * sign], dim=0)


# ---------------------------------------------------------------------------
# axis-angle / rotation matrices
# ---------------------------------------------------------------------------

def axis_angle_to_rotmat(axisang: Tensor) -> Tensor:
    """Batch Rodrigues (N,3) -> (N,3,3) via the quaternion."""
    return quat_to_rotmat(axis_angle_to_quat(axisang))


batch_rodrigues = axis_angle_to_rotmat


def rotmat_to_quat(rotmat: Tensor, eps: float = 1e-6) -> Tensor:
    """(N,3,3) (or (N,3,4)) -> (N,4) wxyz, branch-free 4-case selection."""
    rt = rotmat[..., :3, :3].transpose(-1, -2)

    def m(i, j):
        return rt[..., i, j]

    mask_d2 = m(2, 2) < eps
    mask_d0_d1 = m(0, 0) > m(1, 1)
    mask_d0_nd1 = m(0, 0) < -m(1, 1)

    t0 = 1 + m(0, 0) - m(1, 1) - m(2, 2)
    q0 = torch.stack([m(1, 2) - m(2, 1), t0, m(0, 1) + m(1, 0),
                      m(2, 0) + m(0, 2)], -1)
    t1 = 1 - m(0, 0) + m(1, 1) - m(2, 2)
    q1 = torch.stack([m(2, 0) - m(0, 2), m(0, 1) + m(1, 0), t1,
                      m(1, 2) + m(2, 1)], -1)
    t2 = 1 - m(0, 0) - m(1, 1) + m(2, 2)
    q2 = torch.stack([m(0, 1) - m(1, 0), m(2, 0) + m(0, 2),
                      m(1, 2) + m(2, 1), t2], -1)
    t3 = 1 + m(0, 0) + m(1, 1) + m(2, 2)
    q3 = torch.stack([t3, m(1, 2) - m(2, 1), m(2, 0) - m(0, 2),
                      m(0, 1) - m(1, 0)], -1)

    c0 = mask_d2 & mask_d0_d1
    c1 = mask_d2 & ~mask_d0_d1
    c2 = ~mask_d2 & mask_d0_nd1
    q = torch.where(c0[..., None], q0, torch.where(
        c1[..., None], q1, torch.where(c2[..., None], q2, q3)))
    t = torch.where(c0, t0, torch.where(c1, t1, torch.where(c2, t2, t3)))
    return q * (0.5 / torch.sqrt(t))[..., None]


def rotmat_to_axis_angle(rotmat: Tensor) -> Tensor:
    """(N,3,3) -> (N,3) axis-angle, NaNs zeroed."""
    aa = quat_to_axis_angle(rotmat_to_quat(rotmat))
    return torch.where(torch.isnan(aa), torch.zeros_like(aa), aa)


def rot6d_to_rotmat(x: Tensor) -> Tensor:
    """(N,6) continuous 6D representation -> (N,3,3); Gram-Schmidt with
    eps=1e-6 clamped norms."""
    x = x.reshape(-1, 3, 2)
    a1, a2 = x[..., 0], x[..., 1]
    b1 = _normalize(a1, eps=1e-6)
    dot = torch.sum(b1 * a2, dim=-1, keepdim=True)
    b2 = _normalize(a2 - dot * b1, eps=1e-6)
    b3 = torch.linalg.cross(b1, b2)
    return torch.stack([b1, b2, b3], dim=-1)


def rot6d_to_rotmat_spin(x: Tensor) -> Tensor:
    """SPIN variant with the default-eps normalisation."""
    x = x.reshape(-1, 3, 2)
    a1, a2 = x[..., 0], x[..., 1]
    b1 = _normalize(a1)
    dot = torch.sum(b1 * a2, dim=-1, keepdim=True)
    b2 = _normalize(a2 - dot * b1)
    b3 = torch.linalg.cross(b1, b2)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_rot6d(x: Tensor) -> Tensor:
    """(N,3,3) -> (N,3,2): the first two columns."""
    x = x.reshape(-1, 3, 3)
    return torch.stack([x[..., 0], x[..., 1]], dim=-1)


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------

def convert_weak_perspective_to_perspective(
    weak_cam: Tensor, focal_length: float = 5000.0, img_res: int = 224
) -> Tensor:
    """[s, tx, ty] -> [tx, ty, tz] translation."""
    return torch.stack(
        [
            weak_cam[..., 1],
            weak_cam[..., 2],
            2.0 * focal_length / (img_res * weak_cam[..., 0] + 1e-9),
        ],
        dim=-1,
    )


def perspective_projection(points: Tensor, rotation: Tensor,
                           translation: Tensor, focal_length,
                           camera_center: Tensor) -> Tensor:
    """Project (B,N,3) points with K=[[f,0,cx],[0,f,cy],[0,0,1]] -> (B,N,2)."""
    points = torch.einsum("bij,bkj->bki", rotation, points)
    points = points + translation[:, None, :]
    projected = points / points[..., 2:3]
    f = focal_length  # a number stays a kernel argument (no copy to the card)
    if isinstance(f, Tensor):
        f = f.to(points.device, points.dtype).expand(points.shape[:1])
        f = f[:, None, None]
    return projected[..., :2] * f + camera_center[:, None, :]


def projection(pred_joints: Tensor, pred_camera: Tensor) -> Tensor:
    """Weak-perspective joints -> [-1,1]-normalised 2D."""
    batch = pred_joints.shape[0]
    cam_t = convert_weak_perspective_to_perspective(pred_camera)
    eye = torch.eye(3, dtype=pred_joints.dtype,
                    device=pred_joints.device).expand(batch, 3, 3)
    kp2d = perspective_projection(
        pred_joints, eye, cam_t, 5000.0,
        torch.zeros((batch, 2), dtype=pred_joints.dtype,
                    device=pred_joints.device))
    return kp2d / (224.0 / 2.0)


def estimate_translation_single(S: Tensor, joints_2d: Tensor,
                                joints_conf: Tensor,
                                focal_length: float = 5000.0,
                                img_size: float = 224.0) -> Tensor:
    """Weighted least-squares camera translation for one frame.

    S: (K,3) 3D joints; joints_2d: (K,2); joints_conf: (K,)."""
    kw = dict(dtype=S.dtype, device=S.device)
    num_joints = S.shape[0]
    Z = S[:, 2].repeat_interleave(2)
    XY = S[:, :2].reshape(-1)
    O = torch.full((2 * num_joints,), img_size / 2.0, **kw)
    F = torch.full((2 * num_joints,), focal_length, **kw)
    weight2 = torch.sqrt(joints_conf).repeat_interleave(2)

    j2d_flat = joints_2d.reshape(-1)
    Q = torch.stack(
        [
            F * torch.tensor([1.0, 0.0], **kw).repeat(num_joints),
            F * torch.tensor([0.0, 1.0], **kw).repeat(num_joints),
            O - j2d_flat,
        ],
        dim=-1,
    )
    c = (j2d_flat - O) * Z - F * XY
    Qw = Q * weight2[:, None]
    cw = c * weight2
    return torch.linalg.solve(Qw.T @ Qw, Qw.T @ cw)


def estimate_translation(S: Tensor, joints_2d: Tensor,
                         focal_length: float = 5000.0,
                         img_size: float = 224.0) -> Tensor:
    """Batched translation fit over joints 25: of the 49-joint spin set.

    S: (B,49,3); joints_2d: (B,49,3) with confidence in the last channel."""
    return torch.func.vmap(
        lambda s, j, c: estimate_translation_single(s, j, c, focal_length,
                                                    img_size)
    )(S[:, 25:], joints_2d[:, 25:, :2], joints_2d[:, 25:, 2])
