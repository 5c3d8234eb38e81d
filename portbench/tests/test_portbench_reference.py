"""The plain reference against the port in float64 at small sizes: the same
fleet draw, filter step, front-end and live frame give the same positions."""

import numpy as np
import pytest
import torch

from msckf_mono_tpu_torch.core import pipeline
from msckf_mono_tpu_torch.core.filter import run_sequence
from msckf_mono_tpu_torch.core.init import ground_truth_init
from msckf_mono_tpu_torch.core.types import tree_map
from msckf_mono_tpu_torch.data import synthetic
from msckf_mono_tpu_torch.frontend.functional import FrontendConfig, init_frontend_state
from msckf_mono_tpu_torch.interface import VioInterface
from msckf_mono_tpu_torch.parallel import montecarlo
from msckf_mono_tpu_torch.utils import config as port_config
from portbench.harness import cell as cellmod
from portbench.harness import world
from portbench.harness.fleet import gt_init, job_keys, seq_arrays
from portbench.harness.render import Renderer
from portbench.reference import runner
from tiny import ROOT, SMALL_CAMERA

F64 = torch.float64
B, T = 3, 12


def _config(name, small_camera=False):
    cfg = cellmod.load_json(ROOT / "portbench" / "configs" / f"{name}.json")
    if small_camera:
        cfg["filter_config"]["camera"].update(SMALL_CAMERA)
        if "track_handler" in cfg:
            cfg["track_handler"]["max_features"] = 32
    return cfg


def _world(cfg, n, **kw):
    seq, w = world.generate(cfg, n_frames=n, seed=9, return_world=True, **kw)
    imu0 = dict(gt_init(w), b_g=seq.b_g.tolist(), b_a=seq.b_a.tolist())
    return seq, w, imu0


def _fleet(cfg, imu0, key):
    imu = ground_truth_init(**imu0, dtype=torch.float32, device="cpu")
    drawn = montecarlo.make_fleet(cfg, imu, B, key=key, dtype=torch.float32, device="cpu")
    return tree_map(lambda x: x.to(F64) if x.is_floating_point() else x, drawn)


def test_fleet_on_tracks():
    config = _config("euroc-serving")
    cfg = cellmod.build_config(config, B, port_config)
    seq, _, imu0 = _world(cfg, T, pixel_noise=0.5)
    keys = job_keys(4)
    frames = montecarlo.broadcast_frames(synthetic.to_frame_inputs(seq, F64, device="cpu"), B)
    _, outs = run_sequence(_fleet(cfg, imu0, keys[1]), frames, cfg)
    rows = [(1, 0), (1, 2)]
    ref = runner.fleet_tracks(config, B, seq_arrays(seq), imu0, keys, rows, B, T, F64, "cpu")
    got = outs.p_I_G[:, [0, 2]].numpy()
    np.testing.assert_allclose(got, ref["p"], atol=1e-9, rtol=0)
    np.testing.assert_array_equal(outs.num_residualized[:, [0, 2]].numpy(),
                                  ref["decisions"][..., 0])


def test_fleet_on_one_camera():
    config = _config("euroc-serving", small_camera=True)
    cfg = cellmod.build_config(config, B, port_config)
    n = 8
    seq, w, imu0 = _world(cfg, n, pixel_noise=0.0, n_landmarks=500)
    images = Renderer(cfg, "cpu").frames(w, n, 4)
    keys = job_keys(4)
    fcfg = FrontendConfig(**config["frontend"])
    H, W = images.shape[1:]

    def b(x, dt=F64):
        x = torch.as_tensor(np.asarray(x)[:n]).to(dt)
        return x[:, None].expand((n, B) + tuple(x.shape[1:]))

    frames = pipeline.ImageFrameInput(
        image=images.to(F64), imu_omega=b(seq.imu_omega), imu_acc=b(seq.imu_acc),
        imu_dt=b(seq.imu_dt), state_id=b(np.arange(1, n + 1), torch.int32), time=b(seq.time),
        frame_valid=b(np.ones(n, bool), torch.bool))
    run = pipeline.batched_run_images_shared(cfg, fcfg)
    _, _, outs = run(_fleet(cfg, imu0, keys[0]),
                     init_frontend_state(H, W, fcfg, B, 1, F64, device="cpu"), frames)
    ref = runner.fleet_images(config, B, seq_arrays(seq), imu0, keys, [(0, 1)], B, images, F64,
                              "cpu")
    np.testing.assert_allclose(outs.p_I_G[:, [1]].numpy(), ref["p"], atol=1e-9, rtol=0)


@pytest.mark.parametrize("n", [10])
def test_live_frame(n):
    config = _config("euroc-live", small_camera=True)
    cfg = cellmod.build_config(config, 1, port_config)
    seq, w, imu0 = _world(cfg, n, pixel_noise=0.0, n_landmarks=500)
    images = Renderer(cfg, "cpu").frames(w, n, 4).numpy()
    vio = VioInterface(cfg, dtype=F64, device="cpu", track_handler_kwargs=config["track_handler"])
    vio.initialize_from_ground_truth(**imu0)
    K = seq.imu_omega.shape[1]
    got = []
    for i in range(n):
        for k in range(K):
            vio.imu_callback(seq.imu_omega[i, k], seq.imu_acc[i, k],
                             float(seq.time[i]) - (K - 1 - k) * 0.005, dt=float(seq.imu_dt[i, k]))
        assert vio.image_callback(images[i], float(seq.time[i]))
        got.append(vio.odometry()["p_I_G"])
    ref = runner.live(config, seq_arrays(seq), imu0, images, F64, "cpu")
    np.testing.assert_allclose(np.asarray(got), ref["p"][:, 0], atol=1e-9, rtol=0)
