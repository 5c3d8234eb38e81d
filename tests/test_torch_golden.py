"""The port against the committed golden trajectory, its own copies of the JAX
package's numpy modules, and its import hygiene.

* Golden: the port's ``run_sequence`` in f64 at the default ``MsckfConfig`` on
  ``eval/golden.GOLDEN_SPEC`` reproduces ``tests/golden/synthetic_f64.npz``
  (p, q, v within 1e-6, P trace rtol 1e-6, num_residualized equal). No JAX
  run is needed.
* ``eval/golden``: the port's ``compare_to_golden()`` passes at JAX's own
  tolerances (rtol = atol = 1e-9), ``write_golden`` round-trips through
  ``compare_to_golden(path)``, the committed file's bytes stay as they are,
  and ``--write`` needs ``--path``. One run of the golden sequence serves
  these tests.
* ``data/synthetic.generate`` / ``to_frame_inputs``, ``data/render`` and
  ``eval/ate`` are the port's own copies: they give the JAX package's values
  exactly.
* The package imports neither ``jax`` nor ``msckf_mono_tpu``.
"""

import dataclasses
import hashlib
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_mono_tpu.data import render as jrender
from msckf_mono_tpu.data import synthetic as jsyn
from msckf_mono_tpu.eval import ate as jate
from msckf_mono_tpu.eval import golden as jgolden
from msckf_mono_tpu_torch.core import filter as tfilter
from msckf_mono_tpu_torch.data import render as trender
from msckf_mono_tpu_torch.data import synthetic as tsyn
from msckf_mono_tpu_torch.eval import ate as tate
from msckf_mono_tpu_torch.eval import golden as tgolden
from msckf_mono_tpu_torch.parallel import sharding as tsharding

from tests import _torch_port as tp

REPO = Path(__file__).resolve().parent.parent


def test_reproduces_committed_golden():
    _, tc = tp.configs()
    seq = tsyn.generate(tc, **jgolden.GOLDEN_SPEC)
    state = tp.port_initial_state(tc, seq, torch.float64)
    final, outs = tfilter.run_sequence(state, tp.port_frames(seq, torch.float64), tc)
    golden = np.load(jgolden.DEFAULT_PATH)
    for key, got in (("p", outs.p_I_G), ("q", outs.q_IG), ("v", outs.v_I_G)):
        np.testing.assert_allclose(got[:, 0].numpy(), golden[key], rtol=0, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(torch.trace(final.P[0])), float(golden["P_trace"]), rtol=1e-6)
    assert int(final.num_residualized[0]) == int(golden["num_residualized"])
    np.testing.assert_array_equal(seq.gt_p, golden["gt_p"])
    assert tsharding.fleet_metrics(final)["total_residualized"] == int(golden["num_residualized"])


@pytest.fixture(scope="module")
def golden_run():
    """The port's run_golden_sequence(), once for the module."""
    return tgolden.run_golden_sequence()


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_compare_to_golden_at_jax_tolerances(golden_run, monkeypatch):
    assert tgolden.GOLDEN_SPEC == jgolden.GOLDEN_SPEC
    assert Path(tgolden.DEFAULT_PATH) == Path(jgolden.DEFAULT_PATH)
    monkeypatch.setattr(tgolden, "run_golden_sequence", lambda: golden_run)
    errs = tgolden.compare_to_golden()
    assert set(errs) == {"p", "q", "v"} and max(errs.values()) <= 1e-9, errs
    assert golden_run["p"].dtype == np.float64 and golden_run["p"].shape == (100, 3)


def test_write_golden_round_trips_and_leaves_the_committed_file(golden_run, monkeypatch, tmp_path):
    before = _sha(tgolden.DEFAULT_PATH)
    with pytest.raises(SystemExit):
        tgolden.main(["--write"])
    monkeypatch.setattr(tgolden, "run_golden_sequence", lambda: golden_run)
    path = tgolden.write_golden(str(tmp_path / "golden.npz"))
    assert set(np.load(path)) == set(np.load(tgolden.DEFAULT_PATH))
    assert tgolden.compare_to_golden(path, rtol=0, atol=0) == {"p": 0.0, "q": 0.0, "v": 0.0}
    assert _sha(tgolden.DEFAULT_PATH) == before


def test_synthetic_copy_matches_jax():
    jc, tc = tp.configs(dict(tp.TINY_FILTER), dict(tp.TINY_SHAPES))
    want = jsyn.generate(jc, n_frames=12, seed=5, pixel_noise=0.5)
    got = tsyn.generate(tc, n_frames=12, seed=5, pixel_noise=0.5)
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f.name)

    jf = jsyn.to_frame_inputs(want, jnp.float64)
    tf = tsyn.to_frame_inputs(got, torch.float64, device="cpu")
    for f in dataclasses.fields(jf):
        w, g = np.asarray(getattr(jf, f.name)), getattr(tf, f.name).numpy()
        assert g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_render_copy_matches_jax():
    """Rendered frames of the full camera equal the JAX package's bit for bit,
    on the static background and on the per-frame noise one."""
    jc, tc = tp.configs()
    _, jw = jsyn.generate(jc, n_frames=3, seed=2, pixel_noise=0.0, n_landmarks=500, return_world=True)
    _, tw = tsyn.generate(tc, n_frames=3, seed=2, pixel_noise=0.0, n_landmarks=500, return_world=True)
    for f in range(3):
        want = jrender.render_frame(jc, jw, f)
        got = trender.render_frame(tc, tw, f)
        assert got.dtype == want.dtype == np.float32 and got.shape == (480, 752)
        np.testing.assert_array_equal(got, want, err_msg=f"frame {f}")
    np.testing.assert_array_equal(trender.render_frame(tc, tw, 1, background="dynamic"),
                                  jrender.render_frame(jc, jw, 1, background="dynamic"))
    for f in range(3):
        for g, w in zip(trender.project_frame(tc, tw, f), jrender.project_frame(jc, jw, f)):
            np.testing.assert_array_equal(g, w)


def test_ate_copy_matches_jax():
    rng = np.random.default_rng(0)
    gt = np.cumsum(rng.normal(size=(50, 3)), axis=0)
    est = gt @ np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]]).T + 0.3 + 0.05 * rng.normal(size=gt.shape)
    for align in (True, False):
        assert tate.ate_rmse(est, gt, align=align) == jate.ate_rmse(est, gt, align=align)
    assert tate.final_drift(est, gt) == jate.final_drift(est, gt)
    for with_scale in (True, False):
        for g, w in zip(tate.umeyama_alignment(est, gt, with_scale), jate.umeyama_alignment(est, gt, with_scale)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in (REPO / "msckf_mono_tpu_torch").rglob("*.py")
)


BLOCKED = ("jax", "jaxlib", "flax", "msckf_mono_tpu", "yaml", "PIL")


def test_import_hygiene():
    """Every port module imports with jax, the JAX package, PyYAML and Pillow
    made unimportable (the port's data layer needs neither of the last two)."""
    for kernel in ("psd_cuda", "fast_cuda", "klt_cuda"):
        assert f"msckf_mono_tpu_torch.ops.{kernel}" in MODULES
    for live in ("interface", "cli.run_euroc", "cli.run_synthetic", "frontend.track_handler",
                 "frontend.ransac", "frontend.visualize", "data.asl", "data.sync", "data.penncosy",
                 "data.native_loader", "data.png", "data.write_asl", "data.write_penncosy",
                 "ops.cuda_graph", "eval.timing", "eval.profile", "parallel.checkpoint",
                 "parallel.two_host_sim", "eval.golden"):
        assert f"msckf_mono_tpu_torch.{live}" in MODULES
    assert len(MODULES) >= 57
    code = (
        "import sys, importlib\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
