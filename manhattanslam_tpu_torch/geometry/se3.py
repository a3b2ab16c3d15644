"""SE(3) / SO(3) operations in PyTorch (counterpart of manhattanslam_tpu/geometry/se3.py).

Same conventions as the reference package: ``Tcw`` maps world -> camera as
a 4x4 row-major float32 matrix, twists are translation-first
``(rho, phi)``, quaternions are Hamilton ``(qx, qy, qz, qw)``.  Every
function takes tensors with any leading batch dimensions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (...,3) -> (...,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], -1),
            torch.stack([wz, z, -wx], -1),
            torch.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential: (...,3) -> (...,3,3)."""
    theta2 = torch.sum(w * w, -1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    a = torch.sin(theta) / theta
    b = (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, a)
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    return _eye3(W) + a * W + b * W2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """SO(3) log map: (...,3,3) -> (...,3)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    w_hat = 0.5 * torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        -1,
    )
    scale = torch.where(theta < 1e-6, 1.0 + theta**2 / 6.0,
                        theta / torch.sin(theta).clamp(min=1e-12))
    return w_hat * scale[..., None]


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential, xi = (...,6) as (rho, phi) -> (...,4,4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = exp_so3(phi)
    theta2 = torch.sum(phi * phi, -1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(phi)
    W2 = W @ W
    b = (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS * _EPS)
    c = (theta - torch.sin(theta)) / (theta2 * theta).clamp(min=_EPS**3)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, c)
    V = _eye3(R) + b * W + c * W2
    t = (V @ rho[..., None])[..., 0]
    return make_T(R, t)


@functools.lru_cache(maxsize=None)
def _unit_row(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The (1, 4) row [0, 0, 0, 1], created once per dtype and device (a
    fresh host tensor per call would be a synchronous upload each time)."""
    return torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=dtype, device=device)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (...,4,4) from (...,3,3) and (...,3)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = _unit_row(R.dtype, R.device).expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Rigid-transform inverse: (...,4,4) -> (...,4,4)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_T(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def rot(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def trans(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (4,4) transform to (...,3) points."""
    return pts @ rot(T).transpose(-1, -2) + trans(T)


def transform_dirs(T: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return d @ rot(T).transpose(-1, -2)


def transform_plane(T: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """Hesse plane coeffs (...,4) under the point transform T: planes map
    as pi' = T^-T pi (the row vector pi times T^-1)."""
    return pi @ inverse(T)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (qx, qy, qz, qw), Shepperd's
    method (equal to Eigen::Quaternion(R) up to sign)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 2.0

    sw, sx = root(tr + 1.0), root(1.0 + m00 - m11 - m22)
    sy, sz = root(1.0 + m11 - m00 - m22), root(1.0 + m22 - m00 - m11)
    qw = torch.stack([(m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw, 0.25 * sw], -1)
    qx = torch.stack([0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx, (m21 - m12) / sx], -1)
    qy = torch.stack([(m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy, (m02 - m20) / sy], -1)
    qz = torch.stack([(m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz, (m10 - m01) / sz], -1)
    use_w = tr > 0
    use_x = (~use_w) & (m00 >= m11) & (m00 >= m22)
    use_y = (~use_w) & (~use_x) & (m11 >= m22)
    q = torch.where(use_w[..., None], qw,
                    torch.where(use_x[..., None], qx, torch.where(use_y[..., None], qy, qz)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(qx, qy, qz, qw) -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    s = 2.0 / torch.clamp(x * x + y * y + z * z + w * w, min=_EPS)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack(
        [
            torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
            torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
            torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1),
        ],
        -2,
    )


def project(K: torch.Tensor, pts_cam: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of camera-frame points (...,3) -> pixels (...,2)."""
    z = pts_cam[..., 2:3]
    uv = pts_cam[..., :2] / torch.where(z.abs() < _EPS, torch.full_like(z, _EPS), z)
    return torch.stack([uv[..., 0] * K[0, 0] + K[0, 2], uv[..., 1] * K[1, 1] + K[1, 2]], -1)


def backproject(K: torch.Tensor, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels (...,2) and depth (...,) -> camera-frame points (...,3)."""
    x = (uv[..., 0] - K[0, 2]) / K[0, 0] * depth
    y = (uv[..., 1] - K[1, 2]) / K[1, 1] * depth
    return torch.stack([x, y, depth], -1)


def orthonormalize(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation by SVD (the Manhattan-frame step, Tracking.cc:820-841),
    the last left singular vector flipped where U V^T is improper."""
    U, _, Vt = torch.linalg.svd(M)
    d = torch.linalg.det(U @ Vt)
    U = torch.cat([U[..., :, :-1], U[..., :, -1:] * torch.where(d < 0, -1.0, 1.0)[..., None, None]],
                  -1)
    return U @ Vt


def _inv33(A: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse via the adjugate."""
    c0 = torch.linalg.cross(A[..., 1, :], A[..., 2, :])
    c1 = torch.linalg.cross(A[..., 2, :], A[..., 0, :])
    c2 = torch.linalg.cross(A[..., 0, :], A[..., 1, :])
    det = torch.sum(A[..., 0, :] * c0, -1)
    adjT = torch.stack([c0, c1, c2], dim=-1)
    det = torch.where(det.abs() < 1e-20, torch.full_like(det, 1e-20), det)
    return adjT / det[..., None, None]


def polar_rotation(M: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Polar factor of a 3x3 matrix by the Newton iteration
    X <- (X + X^-T) / 2 (quadratic convergence near a rotation)."""
    X = M
    for _ in range(iters):
        X = 0.5 * (X + _inv33(X).transpose(-1, -2))
    return X


def rotmat_to_quat_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (qx, qy, qz, qw), Shepperd's method,
    in numpy float64 (export path)."""
    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    eps = 1e-12

    sw = np.sqrt(np.clip(tr + 1.0, eps, None)) * 2.0
    qw = np.stack(
        [(m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw, 0.25 * sw], -1
    )
    sx = np.sqrt(np.clip(1.0 + m00 - m11 - m22, eps, None)) * 2.0
    qx = np.stack(
        [0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx, (m21 - m12) / sx], -1
    )
    sy = np.sqrt(np.clip(1.0 + m11 - m00 - m22, eps, None)) * 2.0
    qy = np.stack(
        [(m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy, (m02 - m20) / sy], -1
    )
    sz = np.sqrt(np.clip(1.0 + m22 - m00 - m11, eps, None)) * 2.0
    qz = np.stack(
        [(m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz, (m10 - m01) / sz], -1
    )
    use_w = tr > 0
    use_x = (~use_w) & (m00 >= m11) & (m00 >= m22)
    use_y = (~use_w) & (~use_x) & (m11 >= m22)
    q = np.where(
        use_w[..., None],
        qw,
        np.where(use_x[..., None], qx, np.where(use_y[..., None], qy, qz)),
    )
    return q / np.linalg.norm(q, axis=-1, keepdims=True)
