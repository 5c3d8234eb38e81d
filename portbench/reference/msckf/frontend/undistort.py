"""Lens distortion models (port of ``msckf_mono_tpu/frontend/undistort.py``).

Radtan (plumb-bob) and equidistant fisheye: the forward distortion maps and
the fixed-iteration inverses that stand in for cv::undistortPoints /
cv::fisheye::undistortPoints (pixel in, normalized undistorted out). Points
are ``(..., 2)`` tensors with any leading axes; ``K`` is one ``(3, 3)``
camera matrix shared by all of them.
"""

from __future__ import annotations

import torch


def distort_radtan(xy, coeffs):
    """Normalized coords -> distorted normalized coords. coeffs=(k1,k2,p1,p2[,k3])."""
    k1, k2, p1, p2 = coeffs[0], coeffs[1], coeffs[2], coeffs[3]
    k3 = coeffs[4] if len(coeffs) > 4 else 0.0
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_radtan(xy_dist, coeffs, iters: int = 5):
    """cv::undistortPoints' fixed-point loop; its default 5 iterations
    (TermCriteria(COUNT, 5, 0.01)) are what the reference runs."""
    k1, k2, p1, p2 = coeffs[0], coeffs[1], coeffs[2], coeffs[3]
    k3 = coeffs[4] if len(coeffs) > 4 else 0.0
    x0, y0 = xy_dist[..., 0], xy_dist[..., 1]
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    return torch.stack([x, y], dim=-1)


def distort_equidistant(xy, coeffs):
    """Normalized coords -> fisheye-distorted normalized coords (k1..k4)."""
    k1, k2, k3, k4 = coeffs[0], coeffs[1], coeffs[2], coeffs[3]
    x, y = xy[..., 0], xy[..., 1]
    r = torch.sqrt(torch.clamp_min(x * x + y * y, 1e-18))
    theta = torch.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = theta_d / r
    return torch.stack([x * scale, y * scale], dim=-1)


def undistort_equidistant(xy_dist, coeffs, iters: int = 10):
    """Newton solve of theta_d = theta*(1 + k1 th^2 + ...), cv::fisheye style."""
    k1, k2, k3, k4 = coeffs[0], coeffs[1], coeffs[2], coeffs[3]
    x, y = xy_dist[..., 0], xy_dist[..., 1]
    theta_d = torch.sqrt(torch.clamp_min(x * x + y * y, 1e-18))
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - theta_d
        df = 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + 9 * k4 * t2)))
        theta = theta - f / df
    scale = torch.tan(theta) / theta_d
    return torch.stack([x * scale, y * scale], dim=-1)


def pixels_to_normalized(uv_px, K):
    """(u,v) pixels -> normalized using fx, fy, cx, cy from a 3x3 K."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x = (uv_px[..., 0] - cx) / fx
    y = (uv_px[..., 1] - cy) / fy
    return torch.stack([x, y], dim=-1)


def normalized_to_pixels(xy, K):
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    return torch.stack([xy[..., 0] * fx + cx, xy[..., 1] * fy + cy], dim=-1)


def undistort_points(uv_px, K, coeffs, model: str = "radtan"):
    """Pixel coords -> undistorted normalized coords (cv::undistortPoints with
    no P matrix); unknown models fall back to radtan, as in the reference
    (corner_detector.cpp:431-439)."""
    xy = pixels_to_normalized(uv_px, K)
    if model == "equidistant":
        return undistort_equidistant(xy, coeffs)
    return undistort_radtan(xy, coeffs)
