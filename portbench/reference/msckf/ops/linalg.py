"""Small-matrix linear algebra primitives (port of ``msckf_mono_tpu/ops/linalg.py``).

Closed-form and fixed-shape forms of the filter's tiny solves and projections;
every function broadcasts over leading (batch) axes.
"""

from __future__ import annotations

import torch


def solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 solve via the adjugate; broadcasts over leading axes.

    A: (..., 3, 3), b: (..., 3). Intended for well-damped SPD systems (the LM
    normal equations); the determinant is guarded against exact zero.
    """
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]

    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    det = torch.where(torch.abs(det) > 1e-30, det, torch.full_like(det, 1e-30))

    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10

    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) / det
    x1 = (c01 * b0 + c11 * b1 + c21 * b2) / det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) / det
    return torch.stack([x0, x1, x2], dim=-1)


def null_project_3(H_f: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Rows 3: of QᵀX, where Q is the complete-QR basis of H_f (..., n, 3).

    The left-nullspace projection A_nullᵀX without forming Q: three
    Householder reflectors built on the tiny H_f, applied to X (..., n, W)
    once in compact-WY form QᵀX = X - V Tᵀ (Vᵀ X). Any orthonormal nullspace
    basis yields the identical EKF update.

    Exact-zero rows of H_f produce zero reflector entries, so the matching
    rows of X stay exactly zero — track_projected_rows relies on that (valid
    rows first, zeros after).
    """
    n = H_f.shape[-2]
    dtype = X.dtype
    M = H_f.to(dtype)
    idx = torch.arange(n, device=X.device)
    vs, ts = [], []
    for j in range(3):
        x = torch.where(idx >= j, M[..., :, j], torch.zeros_like(M[..., :, j]))
        xj = x[..., j]
        nrm = torch.sqrt(torch.sum(x * x, dim=-1))
        sign = torch.where(xj >= 0, torch.ones_like(xj), -torch.ones_like(xj))
        alpha = -sign * nrm
        v = x - alpha[..., None] * (idx == j).to(dtype)
        vtv = torch.sum(v * v, dim=-1)
        scale = torch.where(vtv > 1e-30, 2.0 / torch.where(vtv > 1e-30, vtv, torch.ones_like(vtv)),
                            torch.zeros_like(vtv))
        vs.append(v)
        ts.append(scale)
        vM = torch.sum(v[..., :, None] * M, dim=-2)                    # (..., 3)
        M = M - scale[..., None, None] * (v[..., :, None] * vM[..., None, :])

    v1, v2, v3 = vs
    t1, t2, t3 = ts
    a12 = torch.sum(v1 * v2, dim=-1)
    a13 = torch.sum(v1 * v3, dim=-1)
    a23 = torch.sum(v2 * v3, dim=-1)
    # LAPACK larft "forward" T for Q = H1 H2 H3 = I - V T Vᵀ (T upper-tri).
    z = torch.zeros_like(t1)
    T = torch.stack([
        torch.stack([t1, -t1 * t2 * a12, -t3 * (t1 * a13 - t1 * t2 * a12 * a23)], dim=-1),
        torch.stack([z, t2, -t2 * t3 * a23], dim=-1),
        torch.stack([z, z, t3], dim=-1),
    ], dim=-2)                                                         # (..., 3, 3)
    V = torch.stack([v1, v2, v3], dim=-1)                              # (..., n, 3)
    # Qᵀ = H3 H2 H1 = I - V Tᵀ Vᵀ
    VtX = torch.matmul(V.transpose(-1, -2), X)                         # (..., 3, W)
    X = X - torch.matmul(V, torch.matmul(T.transpose(-1, -2), VtX))
    return X[..., 3:, :]


def bmv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., m, k) @ (..., k) -> (..., m) as broadcast-multiply-sum."""
    return torch.sum(A * v[..., None, :], dim=-1)


def bmm_small(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., m, k) @ (..., k, n) -> (..., m, n) as broadcast-multiply-sum (k small)."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)
