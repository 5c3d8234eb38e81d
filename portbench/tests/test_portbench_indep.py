"""The multi-robot cell ``images-indep-b64`` (configuration
``euroc-multirobot``) on the CPU, cut small: robot b flies the loop from
frame k·b with its own frames, IMU and start; the harness serves and checks
it; its per-layer reader and the stage split read what they should; and the
cell is new files and appended entries alone."""

import hashlib
import json
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.harness import cell as cellmod
from portbench.harness import fleet, fleet_indep
from portbench.harness.render import Renderer
from portbench.metrics import frontend_device_ms
from portbench.reference import runner
from tiny import ROOT, last_line, make_tiny, run_cpu

CELL = "images-indep-b64"
CONFIG = "euroc-multirobot"
SEED = 2**31 + 4242
NEW_FILES = ("portbench/configs/euroc-multirobot.json", "portbench/harness/fleet_indep.py", "portbench/reference/runner_indep.py",
             "portbench/metrics/frontend_device_ms.py",
             "portbench/traffic/mc_jobs_images_indep.json")
NEW_METRIC = "frontend_device_ms.image"
APPENDED_TO = ("image_frames_per_s", "capture_s", "device_idle_pct.image",
               "device_ops_per_step.image", "gamma_roofline.image", "fast_roofline.image",
               "klt_roofline.image")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def run(tiny):
    """The cut cell's run on the CPU, its traffic made (3 robots, 12 frames,
    phases 5 frames apart on a 22-frame loop)."""
    cell = cellmod.find_cell(CELL, tiny)
    return fleet_indep.IndependentStreamsRun(cell, SEED, cellmod.Device("cpu"), lambda m: None)


def test_the_cell_serves_and_checks(tiny):
    rc, out, err = run_cpu(tiny, ["--workload", CELL, "--seed", str(SEED), "--seconds", "0.5",
                                  "--trace", "0"])
    assert rc == 0, err[-3000:]
    res = last_line(out)
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "image_frames_per_s"}
    assert set(res["check"]) == {"pos_gap_m", "pyramid_gap"}
    assert "'jax'" not in err and "'msckf_mono_tpu'" not in err


def test_the_cell_runs_a_configuration_of_its_own():
    """The multi-robot deployment is a configuration of its own, with a
    source of its own, its robots the traffic's batch; what it runs is the
    serving caps of the Monte-Carlo fleets, so the two image cells share
    the step and only the front-end's Bi differs."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert entry["config"] == CONFIG
    configs = {c["name"]: c for c in bench["configs"]}
    assert configs[CONFIG]["source"] != configs["euroc-serving"]["source"]
    assert configs[CONFIG]["reduced"] == []
    ours = json.loads((ROOT / configs[CONFIG]["file"]).read_text())
    serving = json.loads((ROOT / configs["euroc-serving"]["file"]).read_text())
    traffic = json.loads((ROOT / "portbench/traffic" / f"{entry['traffic']}.json").read_text())
    assert ours["name"] == CONFIG and ours["source"] == configs[CONFIG]["source"]
    assert ours["robots"] == traffic["batch"] == 64
    described = {"name", "source", "deployment", "robots", "assumed"}
    assert {k: v for k, v in ours.items() if k not in described} == \
        {k: v for k, v in serving.items() if k not in described}


def test_robot_b_sees_the_loop_from_its_phase(run):
    k, B, T = run.k, run.B, run.T
    assert (k, B, T, run.n_loop) == (5, 3, 12, 12 + 2 * 5)
    loop = Renderer(run.cfg, "cpu").frames(run.world, run.n_loop, SEED, 1.0)
    assert torch.equal(run.loop, loop)
    seq, f = run.seq, run.frames
    K = seq.imu_omega.shape[1]
    for b in range(B):
        for t in (0, 1, T - 1):
            i = k * b + t
            assert torch.equal(f.image[t, b], loop[i])
            np.testing.assert_array_equal(f.imu_omega[t, b].numpy(), seq.imu_omega[i].astype(np.float32))
            np.testing.assert_array_equal(f.imu_acc[t, b].numpy(), seq.imu_acc[i].astype(np.float32))
            np.testing.assert_array_equal(f.imu_dt[t, b].numpy(), seq.imu_dt[i].astype(np.float32))
            assert float(f.time[t, b]) == np.float32(seq.time[i])
            assert int(f.state_id[t, b]) == i + 1 and bool(f.frame_valid[t, b])
        # its start is the loop's true state where its first IMU block begins
        start = k * b * K
        np.testing.assert_array_equal(run.starts["p_I_G"][b], run.world.p_seq[start])
        np.testing.assert_array_equal(run.starts["q_IG"][b], run.world.q_seq[start])
        # and its ground truth at frame t is the loop's at frame k·b + t
        assert run.world.frame_idx[k * b] == start + K
        np.testing.assert_array_equal(seq.gt_p[k * b], run.world.p_seq[start + K])
    assert run.starts["p_I_G"][0] == fleet.gt_init(run.world)["p_I_G"]
    assert not torch.equal(f.image[0, 0], f.image[0, 1])


def test_zero_sigmas_start_each_robot_at_its_true_state(run):
    from msckf_mono_tpu_torch.parallel import montecarlo

    still = montecarlo.make_fleet(run.cfg, run.imu, run.B, key=run.keys[0], dtype=torch.float64,
                                  device="cpu", sigma_v=0.0, sigma_theta=0.0, sigma_bg=0.0,
                                  sigma_ba=0.0)
    for b in range(run.B):
        start = run.k * b * run.seq.imu_omega.shape[1]
        p, q = run.world.p_seq[start], run.world.q_seq[start]
        v = (run.world.p_seq[start + 1] - p) / fleet_indep.IMU_DT
        np.testing.assert_allclose(still.imu.p_I_G[b].numpy(), p, rtol=0, atol=1e-5)
        np.testing.assert_allclose(still.imu.q_IG[b].numpy(), q, rtol=0, atol=1e-6)
        np.testing.assert_allclose(still.imu.v_I_G[b].numpy(), v, rtol=0, atol=1e-5)
        np.testing.assert_allclose(still.imu.b_g[b].numpy(), run.seq.b_g, rtol=0, atol=1e-9)


def test_the_draw_is_make_fleets_and_the_references(run):
    """Job j's robot b is make_fleet's filter b under the job's key, centred
    on robot b's start; the reference draws the same row itself."""
    from portbench.reference.msckf.utils import config as ref_config

    drawn = run.make(2)[0]
    rows = [(2, b) for b in range(run.B)]
    ref = runner.fleet_rows(cellmod.build_config(run.cell.config, run.B, ref_config), run.starts,
                            run.keys, rows, run.B, torch.float32, torch.float32, "cpu")
    for name in ("p_I_G", "q_IG", "v_I_G", "b_g", "b_a"):
        np.testing.assert_allclose(getattr(drawn.imu, name).numpy(),
                                   getattr(ref.imu, name).numpy(), rtol=0, atol=1e-7)
    # a perturbed start, not the true one
    assert not np.allclose(drawn.imu.v_I_G[1].numpy(), run.starts["v_I_G"][1], atol=1e-4)


def test_the_check_samples_whole_robots(run):
    assert run.robots == [0, 1, 2]
    rows = run.check_rows([None] * 4, 3)
    assert rows[0] == (0, 0) and [b for _, b in rows] == run.robots
    assert all(0 <= j < 4 for j, _ in rows)


def test_frontend_device_ms_reads_only_a_split_of_its_kind():
    split = SimpleNamespace(stage_ms={"step.frontend": (3.5, 583.0), "step": (14.0, 5400.0)})
    assert frontend_device_ms.read({"kind": "image", "trace": split}, "image") == 3.5
    assert frontend_device_ms.read({"kind": "track", "trace": split}, "image") is None
    assert frontend_device_ms.read({"kind": "image", "trace": split}, "track") is None
    assert frontend_device_ms.read({"kind": "image"}, "image") is None
    assert frontend_device_ms.read({"kind": "image", "trace": SimpleNamespace()}, "image") is None
    assert frontend_device_ms.read({"kind": "image", "trace": SimpleNamespace(stage_ms={})},
                                   "image") is None
    no_frontend = SimpleNamespace(stage_ms={"step.update": (9.0, 2700.0)})
    assert frontend_device_ms.read({"kind": "image", "trace": no_frontend}, "image") is None


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


def _event(name, start, end, id_=0, device=False, annotation=False):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, time_range=_Range(start, end), id=id_, device_type=kind,
                           is_user_annotation=annotation)


def test_stage_split_puts_each_device_event_in_the_ranges_of_its_launch():
    events = [
        _event("step.frontend", 0, 100), _event("frontend.pyramid", 10, 40),
        _event("step.update", 200, 300),
        _event("cudaLaunchKernel", 20, 21, 1), _event("cudaMemcpyAsync", 50, 51, 2),
        _event("cuLaunchKernel", 250, 251, 3), _event("cudaLaunchKernel", 150, 151, 4),
        # a host operator whose id is a device event's: not a launch
        _event("aten::mm", 60, 70, 3),
        _event("kernel_a", 1000, 1010, 1, device=True), _event("Memcpy HtoD", 1010, 1030, 2, device=True),
        _event("kernel_b", 1030, 1060, 3, device=True), _event("kernel_c", 1060, 1061, 4, device=True),
        _event("pb:kernels", 990, 2000, 0, device=True, annotation=True),
    ]
    got = fleet_indep.stage_split(events, 2)
    assert set(got) == {"step", "step.frontend", "frontend.pyramid", "step.update"}
    assert got["step"] == pytest.approx((61 / 2e3, 2.0))
    assert got["step.frontend"] == pytest.approx((30 / 2e3, 1.0))
    assert got["frontend.pyramid"] == pytest.approx((10 / 2e3, 0.5))
    assert got["step.update"] == pytest.approx((30 / 2e3, 0.5))
    assert fleet_indep.stage_split(events[:8], 2) == {}


def _digests(root, skip=()):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts and str(p.relative_to(root)) not in skip}


def _strip(bench):
    """BENCHMARK.json without the cell and what it added."""
    out = json.loads(json.dumps(bench))
    out["configs"] = [c for c in out["configs"] if c["name"] != CONFIG]
    out["workloads"] = [w for w in out["workloads"] if w["name"] != CELL]
    out["per_layer"] = [m for m in out["per_layer"] if m["name"] != NEW_METRIC]
    for m in out["end_to_end"] + out["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != CELL]
    return out


def _append(stripped, bench):
    """``stripped`` with the cell's entries put back at the end of their
    lists, as ``bench`` holds them."""
    out = json.loads(json.dumps(stripped))
    out["configs"].append(next(c for c in bench["configs"] if c["name"] == CONFIG))
    out["workloads"].append(next(w for w in bench["workloads"] if w["name"] == CELL))
    for m in out["end_to_end"] + out["per_layer"]:
        if m["name"] in APPENDED_TO:
            m["workloads"].append(CELL)
    out["per_layer"].append(next(m for m in bench["per_layer"] if m["name"] == NEW_METRIC))
    return out


def test_the_cell_is_new_files_and_appended_entries_only(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    stripped = _strip(bench)
    assert _append(stripped, bench) == bench
    assert CELL not in json.dumps(stripped) and NEW_METRIC not in json.dumps(stripped)
    assert CONFIG not in json.dumps(stripped)

    # a tiny copy as it was without the cell; then the cell's files and entries added
    root = make_tiny(tmp_path / "bench")
    kept = {f: (root / f).read_bytes() for f in NEW_FILES}
    for f in NEW_FILES:
        (root / f).unlink()
    (root / "BENCHMARK.json").write_text(json.dumps(stripped))
    before = _digests(root)
    for f, data in kept.items():
        (root / f).write_bytes(data)
    tiny_bench = json.loads(json.dumps(bench))
    (root / "BENCHMARK.json").write_text(json.dumps(tiny_bench))

    rc, out, err = run_cpu(root, ["--workload", CELL, "--seed", str(SEED + 1), "--seconds", "0.3",
                                  "--trace", "1"])
    assert rc == 0, err[-3000:]
    res = last_line(out)
    assert res["correct"] is True
    # no device on the CPU: of the cell's per-layer metrics only capture_s reads
    assert set(res["metrics"]) == {"capture_s"}
    assert _digests(root, skip=NEW_FILES) == before
    shutil.rmtree(root)
