"""Synthetic image rendering (the port's own copy of ``msckf_mono_tpu/data/render.py``).

Renders each camera frame of a :class:`~msckf_mono_tpu_torch.data.synthetic.SyntheticWorld`
as point-like bright dots (trackable by FAST + KLT as stable corners) over a
world-anchored textured background: a static multi-octave value-noise
texture on a cylinder wall and floor/ceiling planes, ray-cast per pixel
through the distorted camera model, plus a little per-frame sensor noise.
Pure numpy in float64, as the JAX package's renderer runs on the host; the
image of a frame equals that package's bit for bit.
"""

from __future__ import annotations

import numpy as np

from msckf_mono_tpu_torch.data.synthetic import SyntheticWorld, _quat_mul_np, _quat_rotmat_np
from msckf_mono_tpu_torch.utils.config import MsckfConfig


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


def project_frame(config: MsckfConfig, world: SyntheticWorld, frame: int):
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


def camera_pose(config: MsckfConfig, world: SyntheticWorld, frame: int):
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


class StaticBackground:
    """World-anchored background texture sampled by per-pixel ray casting.

    Geometry: a cylinder wall of radius ``cyl_radius`` (outside the landmark
    shell at r in [R+3, R+6]) plus flat floor/ceiling planes. Each pixel's
    ray (undistorted through the camera model, precomputed once) is
    intersected with the geometry and the fixed texture is bilinearly sampled
    at the hit point, so background intensity moves rigidly with the camera.
    """

    def __init__(self, config: MsckfConfig, seed: int = 0, cyl_radius: float = 14.0,
                 z_floor: float = -4.0, z_ceil: float = 5.0,
                 mean: float = 40.0, amplitude: float = 14.0):
        cam = config.camera
        H, W = cam.height, cam.width
        self.mean, self.amplitude = mean, amplitude
        self.R, self.z0, self.z1 = cyl_radius, z_floor, z_ceil

        # per-pixel camera-frame ray directions through the DISTORTED model
        uu, vv = np.meshgrid(np.arange(W, dtype=np.float64),
                             np.arange(H, dtype=np.float64))
        xy_d = np.stack([(uu - cam.c_u) / cam.f_u,
                         (vv - cam.c_v) / cam.f_v], -1).reshape(-1, 2)
        if cam.distortion_model == "equidistant":
            xy = _undistort_equidistant_np(xy_d, cam.distortion_coeffs)
        else:
            xy = _undistort_radtan_np(xy_d, cam.distortion_coeffs, iters=8)
        # unnormalized is fine: o + t*d hits the same point for any scaling
        self.dirs = np.concatenate([xy, np.ones((H * W, 1))], 1).astype(np.float32)
        self.shape = (H, W)

        rng = np.random.default_rng(seed)
        self.tex_wall = _periodic_value_noise(
            rng, (512, 4096), periodic_axes=(1,)).astype(np.float32)
        self.tex_flat = _periodic_value_noise(
            rng, (1024, 1024), periodic_axes=(0, 1)).astype(np.float32)

    @staticmethod
    def _bilinear(tex, u, v, wrap_u=True, wrap_v=False):
        Tv, Tu = tex.shape
        u0 = np.floor(u).astype(int); fu = u - u0
        v0 = np.floor(v).astype(int); fv = v - v0
        if wrap_u:
            u0 %= Tu; u1 = (u0 + 1) % Tu
        else:
            u0 = np.clip(u0, 0, Tu - 1); u1 = np.minimum(u0 + 1, Tu - 1)
        if wrap_v:
            v0 %= Tv; v1 = (v0 + 1) % Tv
        else:
            v0 = np.clip(v0, 0, Tv - 1); v1 = np.minimum(v0 + 1, Tv - 1)
        return (tex[v0, u0] * (1 - fv) * (1 - fu) + tex[v0, u1] * (1 - fv) * fu
                + tex[v1, u0] * fv * (1 - fu) + tex[v1, u1] * fv * fu)

    def render(self, R_CG: np.ndarray, p_C_G: np.ndarray) -> np.ndarray:
        """(H, W) float32 background intensity for the given camera pose."""
        o = np.asarray(p_C_G, np.float32)
        dw = self.dirs @ R_CG.astype(np.float32)  # cam->world
        dx, dy, dz = dw[:, 0], dw[:, 1], dw[:, 2]

        # cylinder |xy| = R: camera is inside, take the positive root
        a = dx * dx + dy * dy
        b = 2.0 * (o[0] * dx + o[1] * dy)
        c = o[0] ** 2 + o[1] ** 2 - self.R ** 2
        disc = np.maximum(b * b - 4 * a * c, 0.0)
        t_cyl = (-b + np.sqrt(disc)) / np.maximum(2 * a, 1e-12)
        z_hit = o[2] + t_cyl * dz
        on_wall = (z_hit >= self.z0) & (z_hit <= self.z1) & (a > 1e-12)

        Tv, Tu = self.tex_wall.shape
        xh = o[0] + t_cyl * dx
        yh = o[1] + t_cyl * dy
        theta = np.arctan2(yh, xh)
        u_wall = (theta * (1.0 / (2 * np.pi)) + 0.5) * Tu
        v_wall = (np.clip(z_hit, self.z0, self.z1) - self.z0) * (
            (Tv - 1) / (self.z1 - self.z0))
        val = self._bilinear(self.tex_wall, u_wall, v_wall, wrap_u=True)

        # floor/ceiling planes (texture repeats every 16 m), sampled only for
        # the off-wall minority of pixels
        off = np.nonzero(~on_wall)[0]
        if off.size:
            dzo = dz[off]
            z_plane = np.where(dzo > 0, self.z1, self.z0)
            t_pl = (z_plane - o[2]) / np.where(np.abs(dzo) < 1e-9, 1e-9, dzo)
            t_pl = np.where(t_pl > 0, t_pl, 1e9)
            xf = o[0] + t_pl * dx[off]
            yf = o[1] + t_pl * dy[off]
            Tf = self.tex_flat.shape[0]
            val[off] = self._bilinear(
                self.tex_flat, xf * (Tf / 16.0), yf * (Tf / 16.0),
                wrap_u=True, wrap_v=True)

        img = self.mean + self.amplitude * val
        return img.reshape(self.shape)


_BG_CACHE: dict = {}


def _static_background(config: MsckfConfig, seed: int) -> StaticBackground:
    cam = config.camera
    key = (seed, cam.f_u, cam.f_v, cam.c_u, cam.c_v, cam.width, cam.height,
           cam.distortion_model, tuple(cam.distortion_coeffs))
    if key not in _BG_CACHE:
        _BG_CACHE[key] = StaticBackground(config, seed=seed)
    return _BG_CACHE[key]


def render_frame(config: MsckfConfig, world: SyntheticWorld, frame: int, seed: int = 0,
                 background: str = "static", sensor_noise: float = 1.0):
    """(H, W) float32 image: bright dots at visible landmark projections over
    the world-anchored textured background (``background="static"``) or a
    per-frame-redrawn noise background (``"dynamic"``, kept for A/Bs)."""
    cam = config.camera
    rng = np.random.default_rng(seed + frame * 7919)
    if background == "static":
        bg = _static_background(config, seed)
        R_CG, p_C_G = camera_pose(config, world, frame)
        img = bg.render(R_CG, p_C_G)
        if sensor_noise:
            img = img + rng.normal(size=img.shape) * sensor_noise
    else:
        img = np.full((cam.height, cam.width), 40.0) + rng.normal(
            size=(cam.height, cam.width)
        )

    uv, visible = project_frame(config, world, frame)
    yy, xx = np.mgrid[0:7, 0:7].astype(np.float64)
    for u, v in uv[visible]:
        ui, vi = int(np.floor(u)), int(np.floor(v))
        y0, x0 = vi - 3, ui - 3
        # the Gaussian is evaluated at the TRUE subpixel center so the
        # rendered dot moves continuously with the projection
        du = u - x0
        dv = v - y0
        kernel = 190.0 * np.exp(-(((xx - du) ** 2) + (yy - dv) ** 2) / 2.2)
        img[y0 : y0 + 7, x0 : x0 + 7] += kernel
    return np.clip(img, 0, 255).astype(np.float32)
