"""The live path's kernel shapes and a live run, on the card.

Every test carries the ``cuda`` marker and skips without a card. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_live_cuda.py -q

* γ at the default configuration's R = 2·28 − 3 = 53 (the one-warp row
  variant at R + 1 = 54) and n = 8 (a chunk of staged tracks of one filter):
  within 1e-3 relative of its plain version, gate decisions identical;
* FAST at B = 1 on a rendered frame: bit-equal; KLT at B = Bi = 1, F = 100:
  good flags identical, positions within 0.05 px;
* ``VioInterface(device="cuda")`` over 30 rendered frames of the full camera
  against the port's own CPU run: the tracker's ids equal for the first 10
  frames (the differing-id count of all 30 is printed and must stay under
  5% of the valid ids), positions finite and within 0.05 m of the CPU run's;
* the same 30 frames with two-point RANSAC on: one replayed graph a frame
  from the second image on, bit-equal (ids and positions) to the eager run
  (``cuda_graph.disabled()``).
"""

import numpy as np
import pytest
import torch

from msckf_mono_tpu_torch.data import render, synthetic
from msckf_mono_tpu_torch.frontend import detect, klt
from msckf_mono_tpu_torch.interface import VioInterface
from msckf_mono_tpu_torch.ops import cuda_graph, fast_cuda, klt_cuda, psd_cuda
from msckf_mono_tpu_torch.utils.chi2 import gate_threshold
from msckf_mono_tpu_torch.utils.config import MsckfConfig

pytestmark = pytest.mark.cuda

N_FRAMES = 30
TH_KW = dict(max_features=100, window_size=21, max_level=3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return "cuda"


@pytest.fixture(scope="module")
def world():
    cfg = MsckfConfig()
    seq, w = synthetic.generate(cfg, n_frames=N_FRAMES, seed=0, pixel_noise=0.0, n_landmarks=500,
                                return_world=True)
    return cfg, seq, np.stack([render.render_frame(cfg, w, i) for i in range(N_FRAMES)])


@pytest.mark.parametrize("n", [1, 8, 16])
def test_gamma_at_r53_matches_plain(card, n):
    R = 2 * MsckfConfig().shapes.num_slots - 3
    assert R == 53 and psd_cuda.launch_plan(R).variant == "warp"
    rng = np.random.default_rng(n)
    X = torch.as_tensor(rng.normal(size=(n, R, R + 4)), device=card)
    S = (X @ X.transpose(-1, -2) / R + 1e-5 * torch.eye(R, dtype=X.dtype, device=card)).float()
    r = torch.as_tensor(rng.normal(size=(n, R)), device=card).float()
    got = psd_cuda.gamma_psd(S.contiguous(), r.contiguous())
    want = psd_cuda.gamma_psd_plain(S, r)
    rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
    assert rel <= 1e-3
    thr = gate_threshold((R + 1) // 2, dtype=torch.float32, device=card)
    assert torch.equal(got < thr, want < thr)


def test_fast_at_b1_equals_plain(card, world):
    _, _, imgs = world
    img = torch.as_tensor(imgs[12:13], device=card)
    assert torch.equal(fast_cuda.fast_nms_score(img, 20.0), fast_cuda.fast_nms_score_plain(img, 20.0))


def test_klt_at_b1_f100_matches_plain(card, world):
    _, _, imgs = world
    pyr0 = klt.build_pyramid(torch.as_tensor(imgs[10:11], device=card), 3)
    pyr1 = klt.build_pyramid(torch.as_tensor(imgs[11:12], device=card), 3)
    xy, _, ok = detect.detect_features(pyr0[0], torch.zeros(1, 100, dtype=torch.bool, device=card))
    corners = xy[0][ok[0]].cpu().numpy()
    rng = np.random.default_rng(0)
    pts0 = corners[rng.integers(0, len(corners), 100)] + rng.normal(0, 0.5, (100, 2))
    pred0 = pts0 + rng.normal(0, 1.0, (100, 2))
    valid = torch.as_tensor(rng.uniform(size=(1, 100)) < 0.9, device=card)
    for lvl in range(4):
        s = 2.0 ** lvl
        args = (pyr0[lvl], pyr1[lvl], torch.as_tensor(pts0[None] / s, dtype=torch.float32, device=card),
                torch.as_tensor(pred0[None] / s, dtype=torch.float32, device=card), valid)
        got = klt_cuda.track_level(*args, window_size=21)
        want = klt_cuda.track_level_plain(*args, window_size=21)
        assert torch.equal(got[1], want[1]), lvl
        err = (got[0] - want[0]).abs().amax(-1)[want[1]]
        assert float(err.max()) <= 0.05, lvl


def _run(device, cfg, seq, imgs, **th_kw):
    vio = VioInterface(cfg, track_handler_kwargs=dict(TH_KW, **th_kw), device=device)
    vio.initialize_from_ground_truth(p_I_G=[5.0, 0.0, 0.0], q_IG=[1, 0, 0, 0],
                                     v_I_G=[0.0, 5.0 * 0.35, 0.2 * 1.4], b_g=seq.b_g, b_a=seq.b_a)
    K = seq.imu_omega.shape[1]
    ids, pos = [], []
    for i in range(N_FRAMES):
        for k in range(K):
            vio.imu_callback(seq.imu_omega[i, k], seq.imu_acc[i, k],
                             float(seq.time[i]) - (K - 1 - k) * 0.005, dt=float(seq.imu_dt[i, k]))
        vio.image_callback(imgs[i], float(seq.time[i]))
        ids.append(vio.track_handler.cur_ids[0].cpu().numpy().copy())
        pos.append(vio.odometry()["p_I_G"])
    replays = [g.replays for g in vio._live_frame.graphs.values()]
    return np.asarray(ids), np.asarray(pos), replays


def test_live_run_on_the_card_matches_the_cpu_run(card, world):
    cfg, seq, imgs = world
    ids_gpu, pos_gpu, _ = _run(card, cfg, seq, imgs)
    ids_cpu, pos_cpu, _ = _run("cpu", cfg, seq, imgs)
    np.testing.assert_array_equal(ids_gpu[:10], ids_cpu[:10])
    differ = int((ids_gpu != ids_cpu).sum())
    n_valid = int((ids_cpu >= 0).sum())
    print(f"ids differing over {N_FRAMES} frames: {differ} of {n_valid} valid")
    assert differ <= 0.05 * n_valid
    assert np.all(np.isfinite(pos_gpu))
    np.testing.assert_allclose(pos_gpu, pos_cpu, rtol=0, atol=0.05)


def test_live_run_with_ransac_replays_the_eager_run(card, world):
    cfg, seq, imgs = world
    ids, pos, replays = _run(card, cfg, seq, imgs, use_ransac=True)
    with cuda_graph.disabled():
        ids_eager, pos_eager, eager_replays = _run(card, cfg, seq, imgs, use_ransac=True)
    assert replays == [N_FRAMES - 1] and eager_replays == []
    np.testing.assert_array_equal(ids, ids_eager)
    np.testing.assert_array_equal(pos, pos_eager)
    assert np.all(np.isfinite(pos)) and int((ids >= 0).sum()) > 0
