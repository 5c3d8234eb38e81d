"""The port's command-line runners on the CPU (``--cpu``).

* ``cli/run_euroc`` on an EuRoC tree the port's writer wrote (the default
  camera, 25 frames of the tracked world, GT init, ``--finish``): the JSON
  report's keys, ATE < 0.5 m and final drift < 1.0 m (the JAX package's own
  bounds, tests/test_write_asl_e2e.py), and the ``--out`` npz keys and
  shapes; the same with ``--dataset pcv`` on a PennCOSYVIO tree and with the
  standstill init;
* ``cli/run_synthetic --cpu --batch 2 --frames 20``: through
  ``make_sharded_run`` on a one-device CPU mesh, the JAX runner's report
  keys, finite and small ATE, and ``--f64`` within 1e-6 m of the JAX
  package's f64 trajectory (same world, zero perturbation);
* against the JAX ``run_euroc`` itself on the same tree: marked slow, since
  the JAX runner's compile of the default-size step alone exceeds a minute on
  this CPU.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from msckf_mono_tpu_torch.cli import run_euroc, run_synthetic
from msckf_mono_tpu_torch.data import synthetic as tsyn
from msckf_mono_tpu_torch.data import write_asl, write_penncosy
from msckf_mono_tpu_torch.utils.config import MsckfConfig

from tests import _torch_port as tp  # noqa: F401  (one intra-op thread)

N_FRAMES = 25
NPZ_KEYS = {"est", "time", "map", "pruned_state_id", "pruned_time", "pruned_q_CG", "pruned_p_C_G"}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    cfg = MsckfConfig()
    seq, world = tsyn.generate(cfg, n_frames=N_FRAMES, seed=3, pixel_noise=0.0, n_landmarks=500,
                               return_world=True)
    asl_root = str(tmp_path_factory.mktemp("mav0"))
    info = write_asl.write_sequence(asl_root, cfg, seq, world)
    pcv_root = str(tmp_path_factory.mktemp("pcv"))
    write_penncosy.write_sequence(pcv_root, cfg, seq, world)
    return asl_root, pcv_root, info


def _run(capsys, argv):
    capsys.readouterr()
    report = run_euroc.main(argv)
    assert json.loads(capsys.readouterr().out) == report
    return report


@pytest.mark.parametrize("dataset", ["asl", "pcv"])
def test_run_euroc_cpu(trees, tmp_path, capsys, dataset):
    asl_root, pcv_root, info = trees
    out = str(tmp_path / "traj.npz")
    report = _run(capsys, ["--data", asl_root if dataset == "asl" else pcv_root,
                           "--dataset", dataset, "--cpu", "--init", "gt",
                           "--stand-still-end", str(info["t0_ns"] / 1e9), "--finish", "--out", out])
    assert set(report) == {"frames", "wall_s", "fps", "ate_rmse", "final_drift"}
    assert report["frames"] == N_FRAMES
    assert report["ate_rmse"] < 0.5, report
    assert report["final_drift"] < 1.0, report
    dat = np.load(out)
    assert set(dat.files) == NPZ_KEYS
    assert dat["est"].shape == (N_FRAMES, 3) and np.all(np.isfinite(dat["est"]))
    assert dat["map"].ndim == 2 and dat["map"].shape[1] == 3 and len(dat["map"]) > 0
    n = len(dat["pruned_state_id"])
    assert dat["pruned_q_CG"].shape == (n, 4) and dat["pruned_p_C_G"].shape == (n, 3)
    # f64 absolute stamps from state_id: frame k+1's time is the k-th frame stamp
    np.testing.assert_array_equal(dat["time"], info["frame_ts"] / 1e9)
    if n:
        np.testing.assert_array_equal(dat["pruned_time"], info["frame_ts"][dat["pruned_state_id"] - 1] / 1e9)


def test_run_euroc_standstill_init_cpu(trees, capsys):
    asl_root, _, info = trees
    report = _run(capsys, ["--data", asl_root, "--cpu", "--init", "standstill",
                           "--stand-still-end", str(info["frame_ts"][2] / 1e9), "--max-frames", "6"])
    assert report["frames"] == 6
    assert np.isfinite(report["ate_rmse"])


def test_run_synthetic_cpu(capsys, monkeypatch):
    from msckf_mono_tpu_torch.parallel import sharding

    meshes = []
    make_sharded_run = sharding.make_sharded_run
    monkeypatch.setattr(sharding, "make_sharded_run",
                        lambda cfg, mesh: meshes.append(mesh) or make_sharded_run(cfg, mesh))
    report = run_synthetic.main(["--cpu", "--batch", "2", "--frames", "20"])
    assert [[str(d) for d in m.devices] for m in meshes] == [["cpu"]]   # through the mesh, as JAX's
    assert json.loads(capsys.readouterr().out) == report
    assert set(report) == {"batch", "frames", "wall_s", "frame_steps_per_s", "ate_mean", "ate_p90",
                           "drift_mean", "metrics"}
    assert set(report["metrics"]) == {"mean_pos_cov_trace", "max_pos_cov_trace", "mean_cam_count",
                                      "total_residualized", "total_row_overflow",
                                      "total_staged_overflow"}
    assert report["batch"] == 2 and report["frames"] == 20
    assert report["ate_mean"] < 0.5 and report["metrics"]["total_residualized"] > 0


def test_run_synthetic_f64_matches_jax(tmp_path, capsys):
    import jax

    from msckf_mono_tpu.core import filter as jfilter
    from msckf_mono_tpu.core.init import ground_truth_init
    from msckf_mono_tpu.core.types import init_filter_state
    from msckf_mono_tpu.data import synthetic as jsyn
    from msckf_mono_tpu.utils.config import MsckfConfig as JConfig

    out = str(tmp_path / "syn.npz")
    run_synthetic.main(["--cpu", "--f64", "--batch", "1", "--frames", "12", "--out", out])
    est = np.load(out)["est"]
    jc = JConfig()
    seq = jsyn.generate(jc, n_frames=12, seed=0, pixel_noise=0.5)
    imu = ground_truth_init(p_I_G=[5.0, 0.0, 0.0], q_IG=[1, 0, 0, 0],
                            v_I_G=[0.0, 5.0 * 0.35, 0.2 * 1.4], b_g=seq.b_g, b_a=seq.b_a,
                            dtype=jnp.float64)
    _, outs = jax.jit(lambda s, f: jfilter.run_sequence(s, f, jc))(
        init_filter_state(jc, imu, dtype=jnp.float64), jsyn.to_frame_inputs(seq, jnp.float64))
    np.testing.assert_allclose(est[:, 0], np.asarray(outs.p_I_G), rtol=0, atol=1e-6)


@pytest.mark.slow
def test_run_euroc_matches_jax_cli(trees, tmp_path, capsys):
    from msckf_mono_tpu.cli import run_euroc as j_run_euroc

    asl_root, _, info = trees
    argv = ["--data", asl_root, "--cpu", "--init", "gt", "--stand-still-end",
            str(info["t0_ns"] / 1e9), "--finish"]
    got = _run(capsys, argv + ["--out", str(tmp_path / "t.npz")])
    j_run_euroc.main(argv + ["--out", str(tmp_path / "j.npz")])
    want = json.loads(capsys.readouterr().out)
    assert got["frames"] == want["frames"]
    assert abs(got["ate_rmse"] - want["ate_rmse"]) < 1e-3
    t, j = np.load(str(tmp_path / "t.npz")), np.load(str(tmp_path / "j.npz"))
    assert set(t.files) == set(j.files) == NPZ_KEYS
    np.testing.assert_allclose(t["est"], j["est"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(t["pruned_state_id"], j["pruned_state_id"])
    assert os.path.exists(str(tmp_path / "j.npz"))


@pytest.mark.parametrize("cli", ["run_euroc", "run_synthetic"])
def test_clis_default_to_the_card(trees, cli):
    """Without --cpu the runners put their tensors on the card; where the
    build has no CUDA that raises at the first such tensor."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the runners would run on it")
    asl_root, _, info = trees
    main, argv = ((run_euroc.main, ["--data", asl_root, "--stand-still-end", str(info["t0_ns"] / 1e9),
                                    "--max-frames", "2"]) if cli == "run_euroc"
                  else (run_synthetic.main, ["--batch", "1", "--frames", "2"]))
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        main(argv)
