"""Trajectory evaluation: Umeyama alignment + ATE RMSE.

The reference validates trajectories visually against the EuRoC ground-truth
path in RViz (reference datasets/asl_msckf.cpp:430-466, README.md:41-43);
this module is the quantitative replacement used by tests and bench gates.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform aligning est -> gt. (T,3) arrays.

    Returns (R (3,3), t (3,), s scalar).
    """
    est = np.asarray(est, float)
    gt = np.asarray(gt, float)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    e = est - mu_e
    g = gt - mu_g
    cov = g.T @ e / est.shape[0]
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (e**2).sum() / est.shape[0]
        s = (d * np.diag(S)).sum() / var_e
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """RMSE of translational error after (optional) SE(3) alignment."""
    if align:
        R, t, s = umeyama_alignment(est, gt)
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def final_drift(est: np.ndarray, gt: np.ndarray) -> float:
    """Unaligned end-point position error (odometry drift)."""
    return float(np.linalg.norm(est[-1] - gt[-1]))
