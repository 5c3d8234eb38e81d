"""The replayed CUDA graphs (ops/cuda_graph.py) on the card.

Every test carries the ``cuda`` marker and skips without a card. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graph_cuda.py -q

Replay against the same run under ``cuda_graph.disabled()`` (eager), on the
same inputs, f32:

* the filter step (serving knobs, 64 filters x 40 frames) and the image step
  (a shared 480 x 752 camera, 16 filters x 12 frames): every counter equal,
  positions within 1e-3 m (the same kernels on the same inputs; the bit
  equality of the whole trajectory is printed, not required, since a
  library may pick another algorithm under capture);
* 30 live frames of ``VioInterface`` and its ``finish()``: the tracker's ids
  equal on every frame, positions within 1e-3 m;
* ``batched_step`` and ``make_jitted_step`` replay their eager step;
* launch counts (FAST, KLT, γ, Shi-Tomasi) are exact after replays (the
  captured count added once a replay), and warm-up leaves them as they were;
* a capture of an operation that synchronizes with the host raises, and
  leaves the device's default generator usable;
* a dropped graph in a reference cycle, freed by the cyclic collector,
  does not invalidate another graph's capture.
"""

import contextlib
import dataclasses
import gc

import numpy as np
import pytest
import torch

from msckf_mono_tpu_torch.core import filter as tfilter
from msckf_mono_tpu_torch.core import pipeline
from msckf_mono_tpu_torch.core.init import ground_truth_init
from msckf_mono_tpu_torch.core.pipeline import ImageFrameInput
from msckf_mono_tpu_torch.core.types import filter_state_to_numpy
from msckf_mono_tpu_torch.data import render, synthetic
from msckf_mono_tpu_torch.frontend import functional
from msckf_mono_tpu_torch.interface import VioInterface
from msckf_mono_tpu_torch.ops import cuda_graph, fast_cuda, klt_cuda, psd_cuda, shi_tomasi_cuda
from msckf_mono_tpu_torch.parallel import montecarlo, sharding
from msckf_mono_tpu_torch.utils.config import MsckfConfig

pytestmark = pytest.mark.cuda

POS_ATOL = 1e-3
INIT = dict(p_I_G=[5.0, 0.0, 0.0], q_IG=[1, 0, 0, 0], v_I_G=[0.0, 5.0 * 0.35, 0.2 * 1.4])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return "cuda"


def serving(batch):
    cfg = MsckfConfig()
    return dataclasses.replace(
        cfg, filter=dataclasses.replace(cfg.filter, fused_updates=True, gating_precision="high"),
        shapes=dataclasses.replace(cfg.shapes, staged_chunk=max(2, 8192 // batch), max_staged=8,
                                   prune_obs_cap=2, marg_obs_cap=22, prune_chunk=48))


def counts():
    return (fast_cuda.fast_nms_score.launches, klt_cuda.track_level.launches,
            psd_cuda.gamma_psd.launches, shi_tomasi_cuda.shi_tomasi_cells.launches)


def _counters(state):
    m = sharding.fleet_metrics(state)
    return {k: int(m[k]) for k in ("total_residualized", "total_row_overflow",
                                   "total_staged_overflow")}


def _compare(tag, got, want):
    """(final state, outputs) of a replayed and an eager run."""
    (gs, go), (ws, wo) = got, want
    assert _counters(gs) == _counters(ws), tag
    for k in ("cam_count", "num_residualized"):
        assert torch.equal(getattr(go, k), getattr(wo, k)), f"{tag} {k}"
    err = float((go.p_I_G - wo.p_I_G).abs().max())
    G, W = filter_state_to_numpy(gs), filter_state_to_numpy(ws)
    same = all(np.array_equal(G[k], W[k]) for k in W) and torch.equal(go.p_I_G, wo.p_I_G)
    print(f"{tag}: bit-equal {same}, max position difference {err:.3e} m")
    assert err <= POS_ATOL, tag


def test_filter_path_replay_equals_eager(card):
    B, T = 64, 40
    cfg = serving(B)
    seq = synthetic.generate(cfg, n_frames=T, seed=0, pixel_noise=0.5)
    imu = ground_truth_init(**INIT, b_g=seq.b_g, b_a=seq.b_a, dtype=torch.float32, device=card)
    frames = montecarlo.broadcast_frames(synthetic.to_frame_inputs(seq, torch.float32, device=card), B)
    make = lambda: montecarlo.make_fleet(cfg, imu, B, dtype=torch.float32, device=card)
    before = counts()
    got = tfilter.run_sequence(make(), frames, cfg)
    assert counts()[2] - before[2] == 2 * T and counts()[3] == before[3]
    with cuda_graph.disabled():
        want = tfilter.run_sequence(make(), frames, cfg)
    _compare("filter path", got, want)
    # the jitted step and the jitted finish replay their eager versions
    step = sharding.batched_step(cfg)
    frame = tfilter.frame_at(frames, T - 1)
    a = step(got[0], frame)
    with cuda_graph.disabled():
        b = step(want[0], frame)
    assert torch.equal(a[1].num_residualized, b[1].num_residualized)
    assert float((a[1].p_I_G - b[1].p_I_G).abs().max()) <= POS_ATOL
    fa = tfilter.finish(got[0], cfg)
    with cuda_graph.disabled():
        fb = tfilter.finish(want[0], cfg)
    assert torch.equal(fa.num_residualized, fb.num_residualized)


def _world(T):
    cfg = MsckfConfig()
    seq, world = synthetic.generate(cfg, n_frames=T, seed=0, pixel_noise=0.0, n_landmarks=500,
                                    return_world=True)
    return seq, np.stack([render.render_frame(cfg, world, i) for i in range(T)])


def test_image_path_replay_equals_eager(card):
    B, T = 16, 12
    cfg = serving(B)
    fcfg = functional.FrontendConfig(max_features=64, window_size=21, max_level=3)
    seq, imgs = _world(T)
    imu = ground_truth_init(**INIT, b_g=seq.b_g, b_a=seq.b_a, dtype=torch.float32, device=card)

    def b(x, dtype=torch.float32):
        x = torch.as_tensor(np.asarray(x)[:T], dtype=dtype, device=card)
        return x[:, None].expand((T, B) + tuple(x.shape[1:]))

    frames = ImageFrameInput(
        image=torch.as_tensor(imgs, device=card), imu_omega=b(seq.imu_omega),
        imu_acc=b(seq.imu_acc), imu_dt=b(seq.imu_dt),
        state_id=b(np.arange(1, T + 1), torch.int32), time=b(seq.time),
        frame_valid=b(np.ones(T, bool), torch.bool))
    run = pipeline.batched_run_images_shared(cfg, fcfg)

    def make():
        return (montecarlo.make_fleet(cfg, imu, B, dtype=torch.float32, device=card),
                functional.init_frontend_state(480, 752, fcfg, B, 1, torch.float32, device=card))

    before = counts()
    s, fs, outs = run(*make(), frames)
    assert tuple(np.subtract(counts(), before)) == (T, 4 * T, 2 * T, T)
    with cuda_graph.disabled():
        ws, wfs, wouts = run(*make(), frames)
    assert torch.equal(fs.ids, wfs.ids) and torch.equal(fs.valid, wfs.valid)
    _compare("image path", (s, outs), (ws, wouts))
    # the jitted front-end step
    step = functional.make_jitted_step(cfg, fcfg)
    dR = torch.eye(3, device=card).expand(B, 3, 3)
    img = frames.image[T - 1][None]
    got = step(fs, img, dR)
    with cuda_graph.disabled():
        want = step(wfs, img, dR)
    assert torch.equal(got[1].tracked_valid, want[1].tracked_valid)
    assert torch.equal(got[1].new_ids, want[1].new_ids)


def _live(device, seq, imgs, T, eager):
    vio = VioInterface(MsckfConfig(), track_handler_kwargs=dict(max_features=100, window_size=21,
                                                                max_level=3), device=device)
    vio.initialize_from_ground_truth(**INIT, b_g=seq.b_g, b_a=seq.b_a)
    K = seq.imu_omega.shape[1]
    ids, pos = [], []
    with cuda_graph.disabled() if eager else contextlib.nullcontext():
        for i in range(T):
            for k in range(K):
                vio.imu_callback(seq.imu_omega[i, k], seq.imu_acc[i, k],
                                 float(seq.time[i]) - (K - 1 - k) * 0.005, dt=float(seq.imu_dt[i, k]))
            vio.image_callback(imgs[i], float(seq.time[i]))
            ids.append(vio.track_handler.cur_ids[0].cpu().numpy())
            pos.append(vio.odometry()["p_I_G"])
        vio.finish()
    return np.asarray(ids), np.asarray(pos), vio


def test_live_replay_equals_eager(card):
    T = 30
    seq, imgs = _world(T)
    before = counts()
    ids, pos, vio = _live(card, seq, imgs, T, eager=False)
    assert tuple(np.subtract(counts(), before)) == (T, 4 * (T - 1), 8 * T + 16, T)
    assert [g.replays for g in vio._live_frame.graphs.values()] == [T - 1]
    wids, wpos, wvio = _live(card, seq, imgs, T, eager=True)
    np.testing.assert_array_equal(ids, wids)
    print(f"live: bit-equal {np.array_equal(pos, wpos)}, max position difference "
          f"{np.abs(pos - wpos).max():.3e} m")
    np.testing.assert_allclose(pos, wpos, rtol=0, atol=POS_ATOL)
    assert len(vio.map()) == len(wvio.map())


def test_launch_bookkeeping_on_replay(card):
    x = torch.ones((1, 64, 64), device=card)

    def fn(carry, img):
        return carry, fast_cuda.fast_nms_score(img + carry, 20.0)

    carry = torch.zeros((), device=card)
    before = counts()
    g = cuda_graph.StepGraph(fn, carry, (x,))
    assert counts() == before, "warm-up and capture count no launch"
    assert g.delta == [0, 1, 0, 0, 0]
    for _ in range(3):
        g(carry, x)
    assert counts()[0] - before[0] == 3


def test_capture_of_a_sync_raises(card):
    x = torch.ones(8, device=card)

    def fn(carry, v):
        return carry, v * float(v.sum())          # a device->host copy

    with pytest.raises(RuntimeError):
        cuda_graph.StepGraph(fn, (), (x,))
    torch.cuda.synchronize()
    assert float((x * 2).sum()) == 16.0            # the card still works
    # and so does its default generator, which the failed capture had held
    assert torch.rand(4, device=card).shape == (4,)


def test_capture_survives_the_cyclic_collector(card):
    x = torch.ones(8, device=card)

    class Holder:
        pass

    held = [cuda_graph.StepGraph(lambda c, v: (c, v * 2), (), (x,))]
    calls = []

    def fn(c, v):
        calls.append(None)
        if len(calls) == 2:                  # the capture (the first call warms up)
            h = Holder()                     # a new cycle, the dropped graph's only owner
            h.graph, h.cycle = held.pop(), h
            del h
            for _ in range(100):
                [[]]                         # allocations that let the collector run
        return c, v + 1

    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)                # a collection at every allocation
    try:
        g = cuda_graph.StepGraph(fn, (), (x,))
    finally:
        gc.set_threshold(*threshold)
    gc.collect()
    _, y = g((), x)
    assert len(calls) == 2 and float(y.sum()) == 16.0
