"""The sharded fleet, checkpoints and the TF32 image tier on the card.

Every test carries the ``cuda`` marker and skips without a card. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sharding_cuda.py -q

At the serving configuration, f32:

* two shards on ``cuda:0`` (one cached graph, run one after the other)
  against one unsharded run of the same fleet (64 filters x 40 frames):
  every counter summed over the shards equal and positions within 2e-2 m
  (tests/test_sharding.py's tolerance; bit equality is printed), 2 gamma
  launches a frame per shard, and the metrics of the shards' mesh equal to
  the unsharded ones (means within 1e-6 relative);
* a checkpoint of the sharded fleet after 20 frames, restored into a fresh
  template on the card and resumed, equals the uninterrupted run bit for
  bit;
* ``image_precision="default"`` against ``"highest"`` on a rendered frame:
  each pyramid level l within 0.5 * l intensity levels (2l TF32 products,
  each within 2^-10 of the 0..255 range) and the Shi-Tomasi map within 1e-2
  of its largest response, and some product must differ (TF32 is in
  force); the image step replayed from its graph at "default" is within
  those bounds of the same step run eagerly and differs from the replayed
  "highest" step (the switch was in force during capture); TF32 is off
  again after it, and a filter run after the image run equals the one
  before it bit for bit.
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from msckf_mono_tpu_torch.core import pipeline
from msckf_mono_tpu_torch.core.init import ground_truth_init
from msckf_mono_tpu_torch.core.pipeline import ImageFrameInput
from msckf_mono_tpu_torch.core.types import _leaves, tree_map
from msckf_mono_tpu_torch.data import render, synthetic
from msckf_mono_tpu_torch.frontend import detect, functional, klt
from msckf_mono_tpu_torch.ops import cuda_graph, psd_cuda
from msckf_mono_tpu_torch.parallel import checkpoint, montecarlo, sharding
from msckf_mono_tpu_torch.utils.config import MsckfConfig, serving_config

pytestmark = pytest.mark.cuda

INIT = dict(p_I_G=[5.0, 0.0, 0.0], q_IG=[1, 0, 0, 0], v_I_G=[0.0, 5.0 * 0.35, 0.2 * 1.4])
B, T = 64, 40
COUNTERS = ("total_residualized", "total_row_overflow", "total_staged_overflow")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels and CUDA graphs have no CPU mode")
    return "cuda"


def _fleet(card, n_frames=T):
    cfg = serving_config(B)
    seq = synthetic.generate(cfg, n_frames=n_frames, seed=0, pixel_noise=0.5)
    imu = ground_truth_init(**INIT, b_g=seq.b_g, b_a=seq.b_a, dtype=torch.float32, device=card)
    frames = montecarlo.broadcast_frames(
        synthetic.to_frame_inputs(seq, torch.float32, device=card), B)
    make = lambda: montecarlo.make_fleet(cfg, imu, B, dtype=torch.float32, device=card)
    return cfg, frames, make


def _equal(a, b):
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(_leaves(a), _leaves(b)))


def test_two_shards_on_one_card_match_one_run(card):
    cfg, frames, make = _fleet(card)
    final, outs = sharding.batched_run_sequence(cfg)(make(), frames)
    want = sharding.fleet_metrics(final)
    mesh = sharding.make_mesh(["cuda:0", "cuda:0"])
    run = sharding.make_sharded_run(cfg, mesh)
    before = psd_cuda.gamma_psd.launches
    s_final, s_outs, metrics = run(sharding.shard_batch(make(), mesh), frames)
    assert psd_cuda.gamma_psd.launches - before == 2 * 2 * T
    assert all(s.P.device == torch.device("cuda:0") for s in s_final.shards)
    got = s_final.gather()
    err = float((s_outs.gather().p_I_G - outs.p_I_G).abs().max())
    print(f"two shards on one card: bit-equal {_equal(got, final)}, max position gap {err:.3e} m")
    assert err <= 2e-2
    for k in COUNTERS:
        assert int(metrics[k]) == int(want[k]), k
    for k in ("mean_pos_cov_trace", "mean_cam_count"):
        np.testing.assert_allclose(float(metrics[k]), float(want[k]), rtol=1e-6, err_msg=k)
    assert float(metrics["max_pos_cov_trace"]) == float(want["max_pos_cov_trace"])


def test_checkpoint_resume_on_the_card(card):
    cfg, frames, make = _fleet(card)
    mesh = sharding.make_mesh(["cuda:0", "cuda:0"])
    run = sharding.make_sharded_run(cfg, mesh)
    ref, _, _ = run(make(), frames)
    mid, _, _ = run(make(), tree_map(lambda x: x[: T // 2], frames))
    with tempfile.TemporaryDirectory() as root:
        path = checkpoint.save(os.path.join(root, "ckpt"), mid, step=T // 2)
        restored = checkpoint.restore(path, sharding.shard_batch(make(), mesh))
    assert all(x.is_cuda for s in restored.shards for _, x in _leaves(s))
    assert all(_equal(a, b) for a, b in zip(restored.shards, mid.shards))
    resumed, _, _ = run(restored, tree_map(lambda x: x[T // 2:], frames))
    assert all(_equal(a, b) for a, b in zip(resumed.shards, ref.shards))


def _world(n):
    cfg = MsckfConfig()
    seq, world = synthetic.generate(cfg, n_frames=n, seed=0, pixel_noise=0.0, n_landmarks=500,
                                    return_world=True)
    return seq, np.stack([render.render_frame(cfg, world, i) for i in range(n)])


def test_default_tier_is_tf32_on_the_image_products_only(card):
    cfg, frames, make = _fleet(card, 10)
    filter_before = sharding.batched_run_sequence(cfg)(make(), frames)

    n = 6
    seq, imgs = _world(n)
    img = torch.as_tensor(imgs[1:2], device=card)
    for level, (a, b) in enumerate(zip(klt.build_pyramid(img, 3, precision="default"),
                                       klt.build_pyramid(img, 3))):
        gap = float((a - b).abs().max())
        print(f"pyramid level {level}: max gap {gap:.4g}")
        assert gap <= 0.5 * level
        if level == 1:
            assert gap > 0, "the default tier ran the pyramid in full f32"
    st_d = detect.shi_tomasi_score(img, precision="default")
    st_h = detect.shi_tomasi_score(img)
    st_gap = float((st_d - st_h).abs().max())
    print(f"Shi-Tomasi: max gap {st_gap:.4g} of {float(st_h.abs().max()):.4g}")
    assert st_gap <= 1e-2 * float(st_h.abs().max())
    assert torch.backends.cuda.matmul.allow_tf32 is False

    # the image step at "default", replayed from its graph and run eagerly
    icfg = serving_config(16)
    fcfg = functional.FrontendConfig(max_features=64, window_size=21, max_level=3,
                                     image_precision="default")
    imu = ground_truth_init(**INIT, b_g=seq.b_g, b_a=seq.b_a, dtype=torch.float32, device=card)

    def b(x, dtype=torch.float32):
        x = torch.as_tensor(np.asarray(x)[:n], dtype=dtype, device=card)
        return x[:, None].expand((n, 16) + tuple(x.shape[1:]))

    iframes = ImageFrameInput(
        image=torch.as_tensor(imgs, device=card), imu_omega=b(seq.imu_omega),
        imu_acc=b(seq.imu_acc), imu_dt=b(seq.imu_dt), state_id=b(np.arange(1, n + 1), torch.int32),
        time=b(seq.time), frame_valid=b(np.ones(n, bool), torch.bool))

    def go(fc):
        return pipeline.batched_run_images_shared(icfg, fc)(
            montecarlo.make_fleet(icfg, imu, 16, dtype=torch.float32, device=card),
            functional.init_frontend_state(480, 752, fc, 16, 1, torch.float32, device=card),
            iframes)

    replayed = go(fcfg)
    with cuda_graph.disabled():
        eager = go(fcfg)
    for level, (x, y) in enumerate(zip(replayed[1].pyramid, eager[1].pyramid)):
        assert float((x - y).abs().max()) <= 0.5 * level
    # had the switch not been in force during the capture, the graph would be the f32 one
    highest = go(dataclasses.replace(fcfg, image_precision="highest"))
    assert not all(torch.equal(x, y) for x, y in zip(replayed[1].pyramid, highest[1].pyramid))
    assert torch.backends.cuda.matmul.allow_tf32 is False

    filter_after = sharding.batched_run_sequence(cfg)(make(), frames)
    assert _equal(filter_after[0], filter_before[0])
    assert torch.equal(filter_after[1].p_I_G, filter_before[1].p_I_G)
