"""The torch renderer against the port's numpy renderer, at a small camera."""

import numpy as np
import torch

from msckf_mono_tpu_torch.data import render as port_render
from msckf_mono_tpu_torch.utils import config as port_config
from portbench.harness import world
from portbench.harness.render import Renderer
from tiny import SMALL_CAMERA


def test_renderer_matches_the_numpy_renderer():
    cfg = port_config.MsckfConfig(camera=port_config.CameraConfig(**SMALL_CAMERA))
    _, w = world.generate(cfg, n_frames=6, seed=5, pixel_noise=0.0, n_landmarks=500,
                          return_world=True)
    r = Renderer(cfg, "cpu")
    for i in (0, 5):
        got = r.frame(w, i, sensor_noise=0.0).numpy()
        want = port_render.render_frame(cfg, w, i, seed=0, sensor_noise=0.0)
        gap = np.abs(got - want)
        # float32 ray casting against the float64 one: a texel's rounding at
        # the floor of a texture coordinate moves a pixel by at most a step
        assert np.mean(gap) < 0.05, np.mean(gap)
        assert np.mean(gap < 1e-2) > 0.99
        assert got.dtype == np.float32 and got.shape == (120, 188)


def test_sensor_noise_is_drawn_from_the_seed():
    cfg = port_config.MsckfConfig(camera=port_config.CameraConfig(**SMALL_CAMERA))
    _, w = world.generate(cfg, n_frames=3, seed=5, pixel_noise=0.0, return_world=True)
    r = Renderer(cfg, "cpu")
    a, b, c = r.frames(w, 3, 7), r.frames(w, 3, 7), r.frames(w, 3, 8)
    assert torch.equal(a, b) and not torch.equal(a, c)
