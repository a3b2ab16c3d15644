"""Closed-form eigenpairs of batched symmetric 3x3 matrices (counterpart of
manhattanslam_tpu/ops/eig33.py).

The trigonometric (Cardano) closed form, op for op as the reference
computes it, including its cofactor determinant: block normals, MSEs,
the seed gate and the 3D line directions read these values, and
``torch.linalg.eigh`` picks and rounds eigenvectors differently.  Every function takes (..., 3, 3).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-20


def _det3(a: torch.Tensor) -> torch.Tensor:
    """3x3 determinant in the reference's term order (jnp.linalg.det's
    closed form for 3x3)."""
    return (
        a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
        + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
        + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
        - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
        - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
        - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2]
    )


def _eigenvalues(A: torch.Tensor) -> torch.Tensor:
    """All three eigenvalues, ascending: (..., 3)."""
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    Bn = B / p[..., None, None]
    r = torch.clamp(_det3(Bn) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    lam2 = q + 2.0 * p * torch.cos(phi)  # largest
    lam1 = 3.0 * q - lam0 - lam2
    return torch.stack([lam0, lam1, lam2], -1)


def _eigenvector(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector for eigenvalue lam: the largest cross product of two
    rows of A - lam I (degenerate input falls back to +z)."""
    C = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = C[..., 0, :], C[..., 1, :], C[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = torch.sum(c01 * c01, -1)
    n02 = torch.sum(c02 * c02, -1)
    n12 = torch.sum(c12 * c12, -1)
    best = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None],
        c01,
        torch.where((n02 >= n12)[..., None], c02, c12),
    )
    nrm = torch.sqrt(torch.clamp(torch.sum(best * best, -1, keepdim=True), min=_EPS))
    v = best / nrm
    degenerate = torch.maximum(torch.maximum(n01, n02), n12) < 1e-18
    fallback = torch.zeros_like(v)
    fallback[..., 2] = 1.0
    return torch.where(degenerate[..., None], fallback, v)


def eig33_smallest(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(smallest eigenvalue (...,), unit eigenvector (..., 3))."""
    lam = _eigenvalues(A)
    return lam[..., 0], _eigenvector(A, lam[..., 0])


def eig33_largest(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(largest eigenvalue (...,), unit eigenvector (..., 3))."""
    lam = _eigenvalues(A)
    return lam[..., 2], _eigenvector(A, lam[..., 2])
