"""Two-point RANSAC on the live path and the benchmark cell ``live-b1-ransac``, on the CPU.

Modules: ``frontend/track_handler.py`` (RANSAC's range ``frontend.ransac``
and its counters ``ransac_frames`` and ``ransac_rejected``), the cell's
plain reference ``portbench/reference/live_ransac.py``, its driver
``portbench/harness/live_ransac.py`` and its reader
``portbench/metrics/ransac_device_ms.py``. The world is the cell's
configuration at a small camera (188 x 120, the EuRoC intrinsics / 4, 32
features), 12 frames rendered by the benchmark's renderer. Tolerances:

* the float32 program and the float64 reference draw the same hypothesis
  pairs from the same carried key (integers: equal), and their positions
  agree within 1e-4 m over the 12 frames: float32's rounding of a ~5 m
  state, carried through the window's updates, reads ~1e-6 m here, while
  the same reference drawing at float64's width (another experiment) parts
  by ~1e-3 m;
* the program in float64 against the reference in float64 (both drawing 64
  bits): positions within 1e-9 m, counters equal;
* the counters against a host recount of what ``two_point_ransac`` kept:
  equal.
"""

import hashlib
import json
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from msckf_mono_tpu_torch.frontend import ransac as transac
from msckf_mono_tpu_torch.frontend import track_handler as tth
from msckf_mono_tpu_torch.interface import VioInterface
from msckf_mono_tpu_torch.utils import config as port_config
from portbench.harness import cell as cellmod
from portbench.harness import world
from portbench.harness.fleet import gt_init, seq_arrays
from portbench.harness.render import Renderer
from portbench.metrics import ransac_device_ms
from portbench.reference import live_ransac
from portbench.reference.msckf.frontend import ransac as rransac
from portbench.tests.tiny import SMALL_CAMERA, last_line, make_tiny, run_cpu
from tests.test_torch_trace import _inside

# The port's CPU tensors here are small: one intra-op thread beside the
# other test workers.
torch.set_num_threads(1)

ROOT = cellmod.ROOT
CELL, CONFIG, BYPASS_CONFIG = "live-b1-ransac", "euroc-live-ransac", "euroc-live"
N = 12
SEED = 2**31 + 1919
F32, F64 = torch.float32, torch.float64
NEW_FILES = ("portbench/configs/euroc-live-ransac.json", "portbench/harness/live_ransac.py",
             "portbench/reference/live_ransac.py", "portbench/metrics/ransac_device_ms.py",
             "portbench/traffic/live_stream_20hz_ransac.json")
NEW_METRIC = "ransac_device_ms.live"
APPENDED_TO = ("live_latency_p50_ms", "capture_s", "device_idle_pct.live",
               "device_ops_per_step.live")


def _config(dtype="float32", **th):
    config = cellmod.load_json(ROOT / "portbench" / "configs" / f"{CONFIG}.json")
    config["filter_config"]["camera"].update(SMALL_CAMERA)
    config["track_handler"].update({"max_features": 32, **th})
    config["dtype"] = dtype
    return config


@pytest.fixture(scope="module")
def scene():
    """The small camera's world: the sequence, its true start and N frames."""
    cfg = cellmod.build_config(_config(), 1, port_config)
    seq, w = world.generate(cfg, n_frames=N, seed=9, pixel_noise=0.0, n_landmarks=500,
                            return_world=True)
    imu0 = dict(gt_init(w), b_g=seq.b_g.tolist(), b_a=seq.b_a.tolist())
    return seq, imu0, Renderer(cfg, "cpu").frames(w, N, 4).numpy()


def _program(config, scene, dtype):
    """The program behind VioInterface over the scene's frames: positions (N, 3) and the interface."""
    seq, imu0, images = scene
    cfg = cellmod.build_config(config, 1, port_config)
    vio = VioInterface(cfg, dtype=dtype, device="cpu",
                       track_handler_kwargs=dict(config["track_handler"]))
    vio.initialize_from_ground_truth(**imu0)
    K = seq.imu_omega.shape[1]
    pos = []
    for i in range(N):
        for k in range(K):
            vio.imu_callback(seq.imu_omega[i, k], seq.imu_acc[i, k],
                             float(seq.time[i]) - (K - 1 - k) * 0.005, dt=float(seq.imu_dt[i, k]))
        assert vio.image_callback(images[i], float(seq.time[i]))
        pos.append(vio.odometry()["p_I_G"])
    return np.asarray(pos), vio


def _reference(config, scene, dtype):
    seq, imu0, images = scene
    return live_ransac.live(config, seq_arrays(seq), imu0, images, dtype, "cpu")


def _recorded(monkeypatch, module, name):
    """Record each call of ``module.name``: (args, result)."""
    calls, fn = [], getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, out))
        return out

    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_the_program_in_f32_and_the_reference_in_f64_draw_the_same_pairs(scene, monkeypatch):
    """Both draw 32 bits from the same carried key; the frozen reference's own
    draw in float64 (64 bits) would score other hypotheses."""
    config = _config()
    drawn = _recorded(monkeypatch, transac, "sample_pairs")
    got, _ = _program(config, scene, F32)
    program = [(args[0].clone(), args[1].clone(), args[3], [x.clone() for x in out])
               for args, out in drawn]
    ref_drawn = _recorded(monkeypatch, rransac, "sample_pairs")
    ref = _reference(config, scene, F64)
    assert len(program) == len(ref_drawn) == N - 1        # every frame after the first
    same_mask = 0
    for t, ((valid, key, bits, pairs), (args, ref_pairs)) in enumerate(zip(program, ref_drawn)):
        assert bits == args[3] == 32, t
        assert torch.equal(key, args[1]), f"frame {t + 1}: the carried keys part"
        # the reference's draw on the program's tracks and key is the program's
        for a, b in zip(rransac.sample_pairs(valid, key, 300, 32), pairs):
            assert torch.equal(a, b), t
        if torch.equal(valid, args[0]):
            same_mask += 1
            assert all(torch.equal(a, b) for a, b in zip(pairs, ref_pairs)), t
    assert same_mask >= N - 3
    valid, key, _, pairs = program[-1]
    assert not torch.equal(rransac.sample_pairs(valid, key, 300, 64)[0], pairs[0])
    gap = np.linalg.norm(got - ref["p"][:, 0], axis=-1).max()
    assert gap < 1e-4, gap
    # the tolerance tells the draws apart: at float64's width the same
    # reference scores other hypotheses and parts by ~1e-3 m
    other = _reference(_config("float64"), scene, F64)
    assert np.linalg.norm(got - other["p"][:, 0], axis=-1).max() > 1e-4


def test_the_program_in_f64_matches_the_reference_in_f64(scene):
    config = _config("float64")
    got, vio = _program(config, scene, F64)
    ref = _reference(config, scene, F64)
    np.testing.assert_allclose(got, ref["p"][:, 0], atol=1e-9, rtol=0)
    th = vio.track_handler
    assert ref["ransac"] == {"ransac_frames": int(th.ransac_frames),
                             "ransac_rejected": int(th.ransac_rejected)}
    assert ref["ransac"]["ransac_rejected"] > 0


@pytest.mark.parametrize("features", [4, 32])
def test_the_counters_equal_a_host_recount(scene, monkeypatch, features):
    """``ransac_rejected`` counts KLT's survivors that RANSAC dropped, and
    ``ransac_frames`` the frames with 5 valid tracks or more, the only ones
    the hypotheses decide (4 features: none), through the frame's graph."""
    calls = _recorded(monkeypatch, transac, "two_point_ransac")
    _, vio = _program(_config(max_features=features), scene, F32)
    valid = [args[3] for args, _ in calls]
    kept = [out for _, out in calls]
    assert len(calls) == N - 1
    frames = sum(int(v.sum()) >= 5 for v in valid)
    rejected = sum(int((v & ~k).sum()) for v, k in zip(valid, kept))
    th = vio.track_handler
    assert th.ransac_frames.dtype == th.ransac_rejected.dtype == torch.int64
    assert th.ransac_frames.shape == th.ransac_rejected.shape == ()
    assert (int(th.ransac_frames), int(th.ransac_rejected)) == (frames, rejected)
    if features < 5:
        assert frames == rejected == 0 and any(int(v.sum()) > 0 for v in valid)
    else:
        assert frames == N - 1 and rejected > 0
    assert set(tth.RANSAC_COUNTERS) <= set(th.carry())


def _ranges(vio, scene):
    """The profiler's ``frontend.*`` events over frames 1-2 (after the first)."""
    seq, _, images = scene
    K = seq.imu_omega.shape[1]

    def frame(i):
        for k in range(K):
            vio.imu_callback(seq.imu_omega[i, k], seq.imu_acc[i, k],
                             float(seq.time[i]) - (K - 1 - k) * 0.005, dt=float(seq.imu_dt[i, k]))
        assert vio.image_callback(images[i], float(seq.time[i]))

    frame(0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        frame(1)
        frame(2)
    return [e for e in prof.events() if e.name.startswith("frontend.")]


@pytest.mark.parametrize("on", [True, False], ids=["ransac-on", "ransac-off"])
def test_frontend_ransac_opens_inside_frontend_track_only_with_ransac_on(scene, on):
    config = _config(use_ransac=on)
    cfg = cellmod.build_config(config, 1, port_config)
    vio = VioInterface(cfg, dtype=F32, device="cpu",
                       track_handler_kwargs=dict(config["track_handler"]))
    vio.initialize_from_ground_truth(**scene[1])
    events = _ranges(vio, scene)
    ransac = [e for e in events if e.name == "frontend.ransac"]
    assert len([e for e in events if e.name == "frontend.track"]) == 2
    if on:
        assert len(ransac) == 2 and all(_inside(e, "frontend.track") for e in ransac)
        assert not any(_inside(e, "frontend.ransac") for e in events if e.name != "frontend.ransac")
    else:
        assert not ransac
        # and the frame carries what it carried before the counters
        assert tuple(vio.track_handler.carry()) == tth.CARRY


def test_ransac_device_ms_reads_only_a_split_of_its_kind():
    split = SimpleNamespace(stage_ms={"frontend.ransac": (1.1, 760.0), "frontend.track": (1.4, 900.0),
                                      "step": (11.0, 8200.0)})
    assert ransac_device_ms.read({"kind": "live", "trace": split}, "live") == 1.1
    assert ransac_device_ms.read({"kind": "image", "trace": split}, "live") is None
    assert ransac_device_ms.read({"kind": "live", "trace": split}, "image") is None
    assert ransac_device_ms.read({"kind": "live"}, "live") is None
    assert ransac_device_ms.read({"kind": "live", "trace": SimpleNamespace()}, "live") is None
    assert ransac_device_ms.read({"kind": "live", "trace": SimpleNamespace(stage_ms={})},
                                 "live") is None
    # the parent's program opens no frontend.ransac
    no_ransac = SimpleNamespace(stage_ms={"frontend.track": (1.4, 900.0), "step": (11.0, 8200.0)})
    assert ransac_device_ms.read({"kind": "live", "trace": no_ransac}, "live") is None


def test_the_cell_runs_a_configuration_of_its_own():
    """``euroc-live-ransac`` is ``euroc-live`` with RANSAC on: every key it
    runs is the bypass's but ``track_handler.use_ransac``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert entry["config"] == CONFIG and entry["chips"] == 1
    configs = {c["name"]: c for c in bench["configs"]}
    assert configs[CONFIG]["source"] != configs[BYPASS_CONFIG]["source"]
    assert configs[CONFIG]["reduced"] == []
    ours = json.loads((ROOT / configs[CONFIG]["file"]).read_text())
    bypass = json.loads((ROOT / configs[BYPASS_CONFIG]["file"]).read_text())
    assert ours["name"] == CONFIG and ours["source"] == configs[CONFIG]["source"]
    assert ours["track_handler"]["use_ransac"] is True
    assert ours["track_handler"]["ransac_threshold"] == 2e-7
    described = {"name", "source", "deployment", "assumed"}
    ours["track_handler"]["use_ransac"] = False
    assert {k: v for k, v in ours.items() if k not in described} == \
        {k: v for k, v in bypass.items() if k not in described}
    traffic = json.loads((ROOT / "portbench/traffic" / f"{entry['traffic']}.json").read_text())
    live = json.loads((ROOT / "portbench/traffic/live_stream_20hz.json").read_text())
    assert traffic["driver"] == "live_ransac"
    assert {k: v for k, v in traffic.items() if k not in ("driver", "why", "check")} == \
        {k: v for k, v in live.items() if k not in ("driver", "why", "check")}
    assert traffic["check"]["limits"]["pos_gap_m"] <= live["check"]["limits"]["pos_gap_m"]
    assert traffic["check"]["control"] == {"reference": {"dtype": "float32", "tf32": True}}


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


# What BENCHMARK.json held before the cell: each of the cell's entries comes
# after all of these in its list, whatever later cells append after it.
BEFORE = {"configs": ("euroc-serving", "euroc-live", "euroc-multirobot"),
          "workloads": ("tracks-b1024", "live-b1-20hz", "images-shared-b256", "images-indep-b64"),
          "per_layer": ("capture_s", "device_idle_pct.track", "device_idle_pct.image",
                        "device_idle_pct.live", "device_ops_per_step.track",
                        "device_ops_per_step.image", "device_ops_per_step.live",
                        "gamma_roofline.track", "gamma_roofline.image", "gamma_roofline.live",
                        "fast_roofline.image", "fast_roofline.live", "klt_roofline.image",
                        "klt_roofline.live", "frontend_device_ms.image")}


def _appended(names, new, before):
    """Whether ``new`` is in ``names`` after every name of ``before`` there."""
    return new in names and all(names.index(new) > names.index(b) for b in before if b in names)


def _appended_only(bench):
    """Whether each of the cell's entries is appended to its list: after
    every entry that was there before it."""
    names = {k: [x["name"] for x in bench[k]] for k in BEFORE}
    ok = (_appended(names["configs"], CONFIG, BEFORE["configs"])
          and _appended(names["workloads"], CELL, BEFORE["workloads"])
          and _appended(names["per_layer"], NEW_METRIC, BEFORE["per_layer"])
          and set(BEFORE["per_layer"]) <= set(names["per_layer"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in APPENDED_TO:
            ok = ok and _appended(m["workloads"], CELL, BEFORE["workloads"])
        elif m["name"] != NEW_METRIC:
            ok = ok and CELL not in m.get("workloads", ())
    return ok


@pytest.mark.parametrize("trace", ["0", "1"])
def test_the_cell_serves_and_checks_and_is_new_files_and_appended_entries_only(tmp_path, trace):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    stripped = _strip(bench)
    assert _appended_only(bench)
    first = json.loads(json.dumps(bench))
    first["workloads"].insert(0, first["workloads"].pop(
        [w["name"] for w in first["workloads"]].index(CELL)))
    assert not _appended_only(first)
    for name in (CELL, NEW_METRIC, CONFIG):
        assert name not in json.dumps(stripped)

    # a tiny copy as it was without the cell; then the cell's files and entries added
    root = make_tiny(tmp_path / "bench")
    kept = {f: (root / f).read_bytes() for f in NEW_FILES}
    for f in NEW_FILES:
        (root / f).unlink()
    (root / "BENCHMARK.json").write_text(json.dumps(stripped))
    before = _digests(root)
    for f, data in kept.items():
        (root / f).write_bytes(data)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, out, err = run_cpu(root, ["--workload", CELL, "--seed", str(SEED + int(trace)),
                                  "--seconds", "0.3", "--trace", trace])
    assert rc == 0, err[-3000:]
    res = last_line(out)
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    # no device on the CPU: traced, of the cell's per-layer metrics only capture_s reads
    want = {"capture_s"} if trace == "1" else {"setup_s", "live_latency_p50_ms"}
    assert set(res["metrics"]) == want
    assert set(res["check"]) == {"pos_gap_m"}
    line = next(x for x in err.splitlines() if x.startswith("[ransac]"))
    assert "the program counters absent" not in line and "frames decided" in line
    assert "'jax'" not in err and "'msckf_mono_tpu'" not in err
    assert _digests(root, skip=NEW_FILES) == before
    shutil.rmtree(root)
