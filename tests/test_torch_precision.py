"""The image-precision tier (``FrontendConfig.image_precision``) on the CPU.

On the card "default" runs the pyramid's and Shi-Tomasi's matrix products in
TF32 (tests/test_torch_sharding_cuda.py holds it against "highest"); on the
CPU it is full f32, as JAX's default precision is on a CPU:

* "default" equals "highest" bit for bit in ``build_pyramid``,
  ``shi_tomasi_score``, ``detect_features`` and ``frontend_step``;
* the port's ``frontend_step`` at "default" matches JAX's at "default" on
  rendered 480 x 752 frames at the front-end tolerances of
  tests/test_torch_pipeline.py (ids and masks equal, uv within 1e-4, f32);
* the new signatures match JAX's (less JAX's TPU-only ``use_pallas``), and
  an unknown tier raises.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from msckf_mono_tpu.frontend import detect as jdetect
from msckf_mono_tpu.frontend import functional as jfunc
from msckf_mono_tpu.frontend import klt as jklt
from msckf_mono_tpu_torch.data import render as trender
from msckf_mono_tpu_torch.data import synthetic as tsyn
from msckf_mono_tpu_torch.frontend import detect as tdetect
from msckf_mono_tpu_torch.frontend import functional as tfunc
from msckf_mono_tpu_torch.frontend import klt as tklt

from tests import _torch_port as tp

H, W = 480, 752
FRONTEND = dict(max_features=64, window_size=21, max_level=3)
N_FRAMES = 3


@pytest.fixture(scope="module")
def images():
    _, tc = tp.configs(dict(tp.TINY_FILTER), dict(tp.TINY_SHAPES))
    _, world = tsyn.generate(tc, n_frames=N_FRAMES, seed=0, pixel_noise=0.0, n_landmarks=500,
                             return_world=True)
    return np.stack([trender.render_frame(tc, world, i) for i in range(N_FRAMES)])


def _dRs():
    rng = np.random.default_rng(0)
    return [Rotation.from_rotvec(rng.normal(size=3) * 0.01).as_matrix() for _ in range(N_FRAMES)]


def test_default_equals_highest_on_the_cpu(images):
    img = torch.as_tensor(images[:1])
    for a, b in zip(tklt.build_pyramid(img, 3, precision="default"), tklt.build_pyramid(img, 3)):
        assert torch.equal(a, b)
    assert torch.equal(tdetect.shi_tomasi_score(img, precision="default"),
                       tdetect.shi_tomasi_score(img))
    occupied = torch.zeros((2, 100), dtype=torch.bool)
    for a, b in zip(tdetect.detect_features(img, occupied, st_precision="default"),
                    tdetect.detect_features(img, occupied)):
        assert torch.equal(a, b)

    _, tc = tp.configs(dict(tp.TINY_FILTER), dict(tp.TINY_SHAPES))
    fcfgs = {p: tfunc.FrontendConfig(**FRONTEND, image_precision=p) for p in ("default", "highest")}
    states = {p: tfunc.init_frontend_state(H, W, fc, 1, 1, torch.float32, device="cpu")
              for p, fc in fcfgs.items()}
    for i, dR in enumerate(_dRs()):
        outs = {}
        for p in states:
            states[p], outs[p] = tfunc.frontend_step(
                states[p], torch.as_tensor(images[i][None]),
                torch.as_tensor(dR[None], dtype=torch.float32), tc, fcfgs[p])
        for k, v in vars(outs["highest"]).items():
            assert torch.equal(getattr(outs["default"], k), v), f"frame {i} {k}"
    assert int(outs["default"].tracked_valid.sum()) > 20


def test_frontend_step_default_matches_jax(images):
    jc, tc = tp.configs(dict(tp.TINY_FILTER), dict(tp.TINY_SHAPES))
    jfc = jfunc.FrontendConfig(**FRONTEND, image_precision="default")
    tfc = tfunc.FrontendConfig(**FRONTEND, image_precision="default")
    jstep = jfunc.make_jitted_step(jc, jfc)
    js = jfunc.init_frontend_state(H, W, jfc, jnp.float32)
    ts = tfunc.init_frontend_state(H, W, tfc, 1, 1, torch.float32, device="cpu")
    for i, dR in enumerate(_dRs()):
        js, jo = jstep(js, jnp.asarray(images[i]), jnp.asarray(dR, jnp.float32))
        ts, to = tfunc.frontend_step(ts, torch.as_tensor(images[i][None]),
                                     torch.as_tensor(dR[None], dtype=torch.float32), tc, tfc)
        for k in ("tracked_ids", "tracked_valid", "new_ids", "new_valid"):
            np.testing.assert_array_equal(getattr(to, k)[0].numpy(), np.asarray(getattr(jo, k)),
                                          err_msg=f"frame {i} {k}")
        for k in ("tracked_uv", "new_uv"):
            np.testing.assert_allclose(getattr(to, k)[0].numpy(), np.asarray(getattr(jo, k)),
                                       rtol=0, atol=1e-4, err_msg=f"frame {i} {k}")
        assert int(ts.next_id[0]) == int(js.next_id)
    assert int(to.tracked_valid.sum()) > 20


def _params(fn, drop=()):
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()
            if p.name not in drop]


def test_signatures_match_jax():
    assert _params(tklt.build_pyramid) == _params(jklt.build_pyramid)
    assert _params(tdetect.shi_tomasi_score) == _params(jdetect.shi_tomasi_score)
    assert _params(tdetect.detect_features) == _params(jdetect.detect_features, ("use_pallas",))
    assert tfunc.FrontendConfig().image_precision == jfunc.FrontendConfig().image_precision


def test_unknown_tier_raises():
    with pytest.raises(ValueError, match="image_precision"):
        tklt.build_pyramid(torch.zeros((1, 16, 16)), 1, precision="high")
