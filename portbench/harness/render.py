"""Camera frames of the synthetic world, rendered on the card.

The port's ``data/render.py`` ray-casts every pixel in float64 numpy on the
host (about a quarter of a second a frame); here the same scene is cast in
float32 torch on the device the frames are served from: bright Gaussian dots
at the landmarks' distorted projections over a world-anchored value-noise
texture (a cylinder wall and floor and ceiling planes), plus per-frame sensor
noise drawn from a ``torch.Generator`` seeded by the run's seed. The
geometry helpers are copies of that module's numpy functions; the textures
and the per-pixel rays are made with numpy once, as there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.harness.world import _quat_mul_np, _quat_rotmat_np


def _distort_radtan_np(xy, coeffs):
    """numpy twin of ``frontend.undistort.distort_radtan``."""
    k1, k2, p1, p2 = coeffs[0], coeffs[1], coeffs[2], coeffs[3]
    k3 = coeffs[4] if len(coeffs) > 4 else 0.0
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def _undistort_radtan_np(xy_dist, coeffs, iters):
    """numpy twin of ``frontend.undistort.undistort_radtan``."""
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
    return np.stack([x, y], axis=-1)


def _undistort_equidistant_np(xy_dist, coeffs, iters=10):
    """numpy twin of ``frontend.undistort.undistort_equidistant``."""
    k1, k2, k3, k4 = coeffs[0], coeffs[1], coeffs[2], coeffs[3]
    x, y = xy_dist[..., 0], xy_dist[..., 1]
    theta_d = np.sqrt(np.maximum(x * x + y * y, 1e-18))
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - theta_d
        df = 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + 9 * k4 * t2)))
        theta = theta - f / df
    scale = np.tan(theta) / theta_d
    return np.stack([x * scale, y * scale], axis=-1)


def project_frame(config, world, frame: int):
    """Pixel positions (with distortion) + visibility of all landmarks."""
    cam = config.camera
    k = world.frame_idx[frame]
    q_IG = world.q_seq[k]
    p_I_G = world.p_seq[k]
    q_CG = _quat_mul_np(np.asarray(cam.q_CI), q_IG)
    R_CG = _quat_rotmat_np(q_CG)
    R_IG = _quat_rotmat_np(q_IG)
    p_C_G = p_I_G + R_IG.T @ np.asarray(cam.p_C_I)

    rel = world.landmarks - p_C_G[None, :]
    p_f_C = rel @ R_CG.T
    z = p_f_C[:, 2]
    safe_z = np.where(np.abs(z) < 1e-9, 1e-9, z)
    xy = p_f_C[:, :2] / safe_z[:, None]

    xy_d = _distort_radtan_np(xy, cam.distortion_coeffs)
    u = xy_d[:, 0] * cam.f_u + cam.c_u
    v = xy_d[:, 1] * cam.f_v + cam.c_v
    margin = 8
    visible = (
        (z > 0.5)
        & (z < 40.0)
        & (u >= margin)
        & (u < cam.width - margin)
        & (v >= margin)
        & (v < cam.height - margin)
    )
    return np.stack([u, v], -1), visible


def camera_pose(config, world, frame: int):
    """(R_CG (3,3) world->cam, p_C_G (3,)) of the camera at ``frame``."""
    cam = config.camera
    k = world.frame_idx[frame]
    q_IG = world.q_seq[k]
    q_CG = _quat_mul_np(np.asarray(cam.q_CI), q_IG)
    R_CG = _quat_rotmat_np(q_CG)
    R_IG = _quat_rotmat_np(q_IG)
    p_C_G = world.p_seq[k] + R_IG.T @ np.asarray(cam.p_C_I)
    return R_CG, p_C_G


def _periodic_value_noise(rng, shape, octaves=4, periodic_axes=(0, 1)):
    """Multi-octave bilinear value noise, optionally periodic per axis."""
    H, W = shape
    out = np.zeros(shape)
    amp = 1.0
    for o in range(octaves):
        gh = max(4, H >> (octaves - 1 - o + 2))
        gw = max(4, W >> (octaves - 1 - o + 2))
        grid = rng.standard_normal((gh, gw))
        # bilinear upsample (wrap on periodic axes, clamp otherwise)
        y = np.linspace(0, gh, H, endpoint=False) if 0 in periodic_axes else \
            np.linspace(0, gh - 1, H)
        x = np.linspace(0, gw, W, endpoint=False) if 1 in periodic_axes else \
            np.linspace(0, gw - 1, W)
        y0 = np.floor(y).astype(int); fy = (y - y0)[:, None]
        x0 = np.floor(x).astype(int); fx = (x - x0)[None, :]
        y1 = (y0 + 1) % gh if 0 in periodic_axes else np.minimum(y0 + 1, gh - 1)
        x1 = (x0 + 1) % gw if 1 in periodic_axes else np.minimum(x0 + 1, gw - 1)
        up = (grid[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
              + grid[np.ix_(y0, x1)] * (1 - fy) * fx
              + grid[np.ix_(y1, x0)] * fy * (1 - fx)
              + grid[np.ix_(y1, x1)] * fy * fx)
        out += amp * up
        amp *= 0.55
    return out / np.abs(out).max()


class Renderer:
    """Renders frames of one camera (``config.camera``) on ``device``.

    The static background is the numpy renderer's (cylinder radius 14 m,
    floor -4 m, ceiling 5 m, mean 40, amplitude 14, textures from
    ``texture_seed``); a frame adds sensor noise of ``sensor_noise`` grey
    levels and a 7 x 7 Gaussian dot of peak 190 at every visible landmark,
    then clips to [0, 255]."""

    def __init__(self, config, device, texture_seed: int = 0, cyl_radius: float = 14.0,
                 z_floor: float = -4.0, z_ceil: float = 5.0, mean: float = 40.0,
                 amplitude: float = 14.0):
        cam = config.camera
        self.config, self.device = config, torch.device(device)
        H, W = cam.height, cam.width
        self.shape = (H, W)
        self.R, self.z0, self.z1 = cyl_radius, z_floor, z_ceil
        self.mean, self.amplitude = mean, amplitude
        uu, vv = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
        xy_d = np.stack([(uu - cam.c_u) / cam.f_u, (vv - cam.c_v) / cam.f_v], -1).reshape(-1, 2)
        if cam.distortion_model == "equidistant":
            xy = _undistort_equidistant_np(xy_d, cam.distortion_coeffs)
        else:
            xy = _undistort_radtan_np(xy_d, cam.distortion_coeffs, iters=8)
        dirs = np.concatenate([xy, np.ones((H * W, 1))], 1).astype(np.float32)
        rng = np.random.default_rng(texture_seed)
        wall = _periodic_value_noise(rng, (512, 4096), periodic_axes=(1,)).astype(np.float32)
        flat = _periodic_value_noise(rng, (1024, 1024), periodic_axes=(0, 1)).astype(np.float32)
        self.dirs = torch.as_tensor(dirs, device=self.device)
        self.tex_wall = torch.as_tensor(wall, device=self.device)
        self.tex_flat = torch.as_tensor(flat, device=self.device)
        yy, xx = torch.meshgrid(torch.arange(7, device=self.device),
                                torch.arange(7, device=self.device), indexing="ij")
        self._yy, self._xx = yy.float(), xx.float()

    @staticmethod
    def _bilinear(tex, u, v, wrap_v):
        Tv, Tu = tex.shape
        u0 = torch.floor(u)
        fu = u - u0
        v0 = torch.floor(v)
        fv = v - v0
        u0 = u0.long() % Tu
        u1 = (u0 + 1) % Tu
        if wrap_v:
            v0 = v0.long() % Tv
            v1 = (v0 + 1) % Tv
        else:
            v0 = v0.long().clamp(0, Tv - 1)
            v1 = (v0 + 1).clamp(max=Tv - 1)
        return (tex[v0, u0] * (1 - fv) * (1 - fu) + tex[v0, u1] * (1 - fv) * fu
                + tex[v1, u0] * fv * (1 - fu) + tex[v1, u1] * fv * fu)

    def background(self, R_CG, p_C_G):
        """(H, W) float32 background for a camera pose (numpy R_CG, p_C_G)."""
        o = torch.as_tensor(np.asarray(p_C_G, np.float32), device=self.device)
        dw = self.dirs @ torch.as_tensor(np.asarray(R_CG, np.float32), device=self.device)
        dx, dy, dz = dw[:, 0], dw[:, 1], dw[:, 2]
        a = dx * dx + dy * dy
        b = 2.0 * (o[0] * dx + o[1] * dy)
        c = o[0] ** 2 + o[1] ** 2 - self.R ** 2
        disc = torch.clamp_min(b * b - 4 * a * c, 0.0)
        t_cyl = (-b + torch.sqrt(disc)) / torch.clamp_min(2 * a, 1e-12)
        z_hit = o[2] + t_cyl * dz
        on_wall = (z_hit >= self.z0) & (z_hit <= self.z1) & (a > 1e-12)
        Tv, Tu = self.tex_wall.shape
        theta = torch.atan2(o[1] + t_cyl * dy, o[0] + t_cyl * dx)
        u_wall = (theta * (1.0 / (2 * math.pi)) + 0.5) * Tu
        v_wall = (torch.clamp(z_hit, self.z0, self.z1) - self.z0) * ((Tv - 1) / (self.z1 - self.z0))
        wall = self._bilinear(self.tex_wall, u_wall, v_wall, wrap_v=False)
        z_plane = torch.where(dz > 0, torch.full_like(dz, self.z1), torch.full_like(dz, self.z0))
        t_pl = (z_plane - o[2]) / torch.where(dz.abs() < 1e-9, torch.full_like(dz, 1e-9), dz)
        t_pl = torch.where(t_pl > 0, t_pl, torch.full_like(t_pl, 1e9))
        Tf = self.tex_flat.shape[0]
        flat = self._bilinear(self.tex_flat, (o[0] + t_pl * dx) * (Tf / 16.0),
                              (o[1] + t_pl * dy) * (Tf / 16.0), wrap_v=True)
        val = torch.where(on_wall, wall, flat)
        return (self.mean + self.amplitude * val).reshape(self.shape)

    def frame(self, world, i: int, generator=None, sensor_noise: float = 1.0):
        """Frame ``i`` of ``world`` as an (H, W) float32 tensor on the device."""
        img = self.background(*camera_pose(self.config, world, i))
        if sensor_noise:
            img = img + sensor_noise * torch.randn(self.shape, generator=generator,
                                                   device=self.device)
        uv, visible = project_frame(self.config, world, i)
        uv = torch.as_tensor(uv[visible], dtype=torch.float32, device=self.device)
        if uv.shape[0]:
            top_left = torch.floor(uv) - 3                      # (n, 2) x0, y0
            du = (uv[:, 0] - top_left[:, 0])[:, None, None]
            dv = (uv[:, 1] - top_left[:, 1])[:, None, None]
            dots = 190.0 * torch.exp(-((self._xx - du) ** 2 + (self._yy - dv) ** 2) / 2.2)
            rows = (top_left[:, 1, None, None] + self._yy).long()
            cols = (top_left[:, 0, None, None] + self._xx).long()
            img = img.index_put((rows.reshape(-1), cols.reshape(-1)), dots.reshape(-1),
                                accumulate=True)
        return torch.clamp(img, 0, 255)

    def frames(self, world, n: int, seed: int, sensor_noise: float = 1.0):
        """Frames 0..n-1 as an (n, H, W) float32 tensor on the device; the
        sensor noise is drawn from ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed % 2**63)
        out = torch.empty((n,) + self.shape, dtype=torch.float32, device=self.device)
        for i in range(n):
            out[i] = self.frame(world, i, gen, sensor_noise)
        return out
