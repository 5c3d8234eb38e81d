"""The image path's 200-frame ATE against the JAX package's, on the CPU (slow: ~6 min).

``bench.py --images`` reports ATE(filter 0) for the shared-camera serving
configuration; the port's ``chip_smoke.py`` reports the same metric for its
own fleet. This test runs both packages from the same initial states on the
same rendered frames, at ``image_precision="highest"`` (the port has no other
tier), 2 filters sharing the camera:

* row 0 is filter 0 of the JAX package's ``make_fleet`` (key 0), which under
  JAX's partitionable threefry does not depend on the batch size: the
  bench's filter 0 at any batch;
* row 1 is filter 0 of the port's ``make_fleet`` (key 0) at B = 256, which
  draws JAX's numbers: it is bit-equal to row 0, so both rows run one filter.

Both packages must agree on each row: ATE within 1e-3 m of each other,
positions within 2e-3 m on every frame (f32 over 200 frames), residualized
counts and feature ids equal. Run with ``-s`` for the numbers:

    python -m pytest tests/test_torch_image_ate.py -m slow -s -q
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_mono_tpu.core import pipeline as jpipe
from msckf_mono_tpu.core.init import ground_truth_init as j_gt_init
from msckf_mono_tpu.data import render as jrender
from msckf_mono_tpu.data import synthetic as jsyn
from msckf_mono_tpu.eval.ate import ate_rmse
from msckf_mono_tpu.frontend import functional as jfunc
from msckf_mono_tpu.parallel import montecarlo as jmc
from msckf_mono_tpu.utils import config as jcfg
from msckf_mono_tpu_torch.core import pipeline as tpipe
from msckf_mono_tpu_torch.core.init import ground_truth_init as t_gt_init
from msckf_mono_tpu_torch.core.types import filter_state_from_numpy, filter_state_to_numpy
from msckf_mono_tpu_torch.frontend import functional as tfunc
from msckf_mono_tpu_torch.parallel import montecarlo as tmc
from msckf_mono_tpu_torch.utils import config as tcfg

from tests import _torch_port as tp

T, B = 200, 2
FRONTEND = dict(max_features=64, window_size=21, max_level=3, image_precision="highest")


def _serving(mod):
    """bench.py:117-164's serving configuration at batch 256 (bench.py --images)."""
    c = mod.MsckfConfig()
    c = dataclasses.replace(c, filter=dataclasses.replace(c.filter, fused_updates=True,
                                                          gating_precision="high"))
    return dataclasses.replace(c, shapes=dataclasses.replace(
        c.shapes, staged_chunk=32, max_staged=8, prune_obs_cap=2, marg_obs_cap=22, prune_chunk=48))


def _stacked(seq):
    return lambda x: np.broadcast_to(np.asarray(x)[:T, None], (T, B) + np.asarray(x).shape[1:])


@pytest.mark.slow
def test_image_path_ate_matches_jax_at_highest_precision():
    jc, tc = _serving(jcfg), _serving(tcfg)
    seq, world = jsyn.generate(jc, n_frames=T, seed=0, pixel_noise=0.0, n_landmarks=500,
                               return_world=True)
    imgs = np.stack([jrender.render_frame(jc, world, i) for i in range(T)]).astype(np.float32)
    H, W = imgs.shape[1:]

    jimu = j_gt_init(**tp.INIT, b_g=seq.b_g, b_a=seq.b_a, dtype=jnp.float32)
    small = tp.jax_to_dict(jmc.make_fleet(jc, jimu, B, key=jax.random.PRNGKey(0)))
    large = tp.jax_to_dict(jmc.make_fleet(jc, jimu, 256, key=jax.random.PRNGKey(0)))
    for k in small:
        np.testing.assert_array_equal(small[k][0], large[k][0], err_msg=f"JAX filter 0 {k}")
    timu = t_gt_init(**tp.INIT, b_g=seq.b_g, b_a=seq.b_a, dtype=torch.float32, device="cpu")
    port = filter_state_to_numpy(tmc.make_fleet(tc, timu, 256, dtype=torch.float32, device="cpu"))
    for k in small:
        np.testing.assert_array_equal(port[k][0], small[k][0], err_msg=f"port filter 0 {k}")
    arrays = {k: np.concatenate([small[k][:1], port[k][:1]]) for k in small}

    b = _stacked(seq)
    jfc, tfc = jfunc.FrontendConfig(**FRONTEND), tfunc.FrontendConfig(**FRONTEND)
    f0 = jfunc.init_frontend_state(H, W, jfc, jnp.float32)
    jframes = jpipe.ImageFrameInput(
        image=jnp.asarray(imgs), imu_omega=jnp.asarray(b(seq.imu_omega), jnp.float32),
        imu_acc=jnp.asarray(b(seq.imu_acc), jnp.float32), imu_dt=jnp.asarray(b(seq.imu_dt), jnp.float32),
        state_id=jnp.asarray(b(np.arange(1, T + 1, dtype=np.int32))),
        time=jnp.asarray(b(seq.time), jnp.float32), frame_valid=jnp.asarray(b(np.ones(T, bool))))
    js, jfs, jo = jax.jit(jpipe.batched_run_images_shared(jc, jfc))(
        tp.jax_state(arrays, jc, jnp.float32),
        jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), f0), jframes)

    def t(x, dtype=None):
        return torch.tensor(np.asarray(x), dtype=dtype)

    tframes = tpipe.ImageFrameInput(
        image=t(imgs), imu_omega=t(b(seq.imu_omega), torch.float32),
        imu_acc=t(b(seq.imu_acc), torch.float32), imu_dt=t(b(seq.imu_dt), torch.float32),
        state_id=t(b(np.arange(1, T + 1, dtype=np.int32))), time=t(b(seq.time), torch.float32),
        frame_valid=t(b(np.ones(T, bool))))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        ts, tfs, to = tpipe.batched_run_images_shared(tc, tfc)(
            filter_state_from_numpy(arrays, device="cpu"),
            tfunc.init_frontend_state(H, W, tfc, B, 1, torch.float32, device="cpu"), tframes)
    finally:
        torch.set_num_threads(threads)

    jp, pp = np.asarray(jo.p_I_G), to.p_I_G.numpy()
    for row, name in ((0, "JAX make_fleet filter 0 (the bench's)"),
                      (1, "the port's make_fleet filter 0 at B = 256")):
        d = np.abs(pp[:, row] - jp[:, row]).max(-1)
        ate_j, ate_t = ate_rmse(jp[:, row], seq.gt_p[:T]), ate_rmse(pp[:, row], seq.gt_p[:T])
        print(f"{name}: ATE JAX {ate_j:.4f} m, port {ate_t:.4f} m; position difference max "
              f"{d.max():.3e} m, at frames 50/100/150/199 {d[50]:.2e} / {d[100]:.2e} / "
              f"{d[150]:.2e} / {d[T - 1]:.2e} m")
        assert abs(ate_j - ate_t) <= 1e-3, name
        assert d.max() <= 2e-3, name
    np.testing.assert_array_equal(ts.num_residualized.numpy(), np.asarray(js.num_residualized))
    np.testing.assert_array_equal(tfs.next_id.numpy(), np.asarray(jfs.next_id))
