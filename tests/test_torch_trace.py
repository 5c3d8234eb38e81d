"""The port's tracing (``eval/profile``: ``span``, ``stage``, the recorder) on the CPU.

* with recording off and no profiler, ``span`` and ``stage`` are the one
  shared no-op and record nothing;
* with recording on, spans nest: parent index, request id (inherited, or
  given), attributes, the order they open in, and the bounded buffer's
  drop count;
* under a profiler a span and a stage are ranges of the trace's host
  operators, not user annotations (which the profiler would mirror onto the
  device's timeline as device events);
* a CPU ``VioInterface`` frame records ``live.frame`` with its children in
  order, and ``live.imu`` under the next frame's id; ``cuda_graph.scan``
  records ``scan.step`` around ``scan.slice``, ``graph.load``,
  ``graph.replay`` and ``scan.stack`` each step;
* under a CPU ``torch.profiler`` an eager ``core/filter.step`` (fused and
  sequential updates), ``frontend_step`` and ``core/pipeline.step`` emit
  their stage ranges, nested as named, and a ``VioInterface`` frame emits
  the image step's ``frontend.*`` ranges inside ``step.frontend``;
* the static-buffer path gives bit-equal outputs with recording on and off;
* ``ops/cuda_build`` counts nvcc runs and libraries found built.
"""

import contextlib

import numpy as np
import pytest
import torch

from msckf_mono_tpu_torch import interface as tint
from msckf_mono_tpu_torch.core import filter as tfilter
from msckf_mono_tpu_torch.core import pipeline as tpipe
from msckf_mono_tpu_torch.core.init import ground_truth_init
from msckf_mono_tpu_torch.data import render as trender
from msckf_mono_tpu_torch.data import synthetic as tsyn
from msckf_mono_tpu_torch.eval import profile
from msckf_mono_tpu_torch.frontend import functional as tfunc
from msckf_mono_tpu_torch.ops import cuda_build, cuda_graph
from msckf_mono_tpu_torch.parallel import montecarlo as tmc
from msckf_mono_tpu_torch.utils import config as tcfg
from msckf_mono_tpu_torch.utils import prng

from tests import _torch_port as tp

_cam0 = tcfg.CameraConfig()
SMALL_CAMERA = dict(f_u=_cam0.f_u / 4, f_v=_cam0.f_v / 4, c_u=_cam0.c_u / 4, c_v=_cam0.c_v / 4,
                    width=188, height=120)
TH_KW = dict(max_features=16, window_size=21, max_level=3)
FRONTEND = dict(max_features=16, window_size=21, max_level=3)
T = 4
FILTER_STAGES = ["step.propagate", "step.augment", "step.tracks", "step.update",
                 "step.prune_empty"]
UPDATE_STAGES = {True: ["update.rows", "update.ekf", "update.post"],
                 False: ["update.marginalize", "update.prune"]}
FRONTEND_STAGES = ["frontend.pyramid", "frontend.track", "frontend.detect", "frontend.dedup"]


@pytest.fixture(autouse=True)
def fresh_recorder():
    """Each test starts and ends with the recorder off and empty."""
    before = profile.set_recording(False)
    profile.reset()
    yield
    profile.set_recording(before)
    profile.reset()


def _configs(fused, camera=False):
    f = dict(tp.TINY_FILTER, max_track_length=6, fused_updates=fused,
             use_prune_redundant=True)
    s = dict(tp.TINY_SHAPES)
    cam = tcfg.CameraConfig(**SMALL_CAMERA) if camera else tcfg.CameraConfig()
    return tcfg.MsckfConfig(camera=cam, filter=tcfg.FilterConfig(**f), shapes=tcfg.ShapeConfig(**s))


@pytest.fixture(scope="module")
def world():
    """The small camera's config, a synthetic sequence and its rendered frames."""
    tc = _configs(False, camera=True)
    seq, w = tsyn.generate(tc, n_frames=T, seed=0, pixel_noise=0.0, n_landmarks=500,
                           return_world=True)
    return tc, seq, np.stack([trender.render_frame(tc, w, i) for i in range(T)])


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent.index]


PROGRAM_PREFIXES = ("step.", "update.", "frontend.", "live.", "graph.", "scan.", "build.")


def _profiled_ranges(fn):
    """The profiler's ranges of the program in ``fn()``, as {name: [event]}."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = {}
    for e in prof.events():
        if e.name.startswith(PROGRAM_PREFIXES):
            assert e.device_type == torch.autograd.DeviceType.CPU and not e.is_user_annotation
            out.setdefault(e.name, []).append(e)
    return out


def _inside(event, name):
    """Whether ``event`` lies inside a range named ``name`` (its parents)."""
    p = event.cpu_parent
    while p is not None:
        if p.name == name:
            return True
        p = p.cpu_parent
    return False


def test_span_and_stage_are_the_shared_noop_when_off():
    assert not profile.profiling()
    assert profile.span("live.frame") is profile.span("scan.step", request=3, attrs={"graph": "g"})
    assert profile.stage("step.update") is profile.span("graph.replay")
    with profile.span("live.frame"), profile.stage("step.update"):
        pass
    assert profile.spans() == [] and profile.RECORDER.dropped == 0


def test_recording_nests_spans():
    with profile.recording() as rec:
        with profile.span("live.frame", request=7):
            with profile.span("live.drain"):
                pass
            with profile.span("graph.replay", attrs={"graph": "frame"}):
                with profile.span("inner", request=9):
                    pass
        with profile.span("scan.step"):
            pass
    assert rec is profile.RECORDER and not profile.RECORDER.on
    got = profile.spans()
    assert [s.name for s in got] == ["live.frame", "live.drain", "graph.replay", "inner",
                                     "scan.step"]
    assert [s.index for s in got] == [0, 1, 2, 3, 4]
    assert [s.parent for s in got] == [None, 0, 0, 2, None]
    assert [s.request for s in got] == [7, 7, 7, 9, None]
    assert got[2].attrs == {"graph": "frame"} and got[0].attrs == {}
    assert not any(s.profiled for s in got)
    for s in got:
        assert s.end_ns >= s.start_ns
    frame, drain, replay, inner, _ = got
    assert frame.start_ns <= drain.start_ns <= drain.end_ns <= replay.start_ns
    assert replay.start_ns <= inner.start_ns <= inner.end_ns <= replay.end_ns <= frame.end_ns


def test_bounded_buffer_drops_the_oldest():
    rec = profile.Recorder(capacity=3)
    rec.on = True
    for i in range(5):
        with rec.span(f"s{i}", request=i):
            pass
    got = rec.spans()
    assert [s.name for s in got] == ["s2", "s3", "s4"]
    assert [s.index for s in got] == [2, 3, 4] and rec.dropped == 2
    rec.reset()
    assert rec.spans() == [] and rec.dropped == 0


def test_set_recording_returns_the_state_before():
    assert profile.set_recording(True) is False
    with profile.recording(False):
        assert not profile.RECORDER.on
        with profile.span("x"):
            pass
    assert profile.RECORDER.on and profile.spans() == []
    assert profile.set_recording(False) is True


@pytest.mark.parametrize("recording", [False, True], ids=["off", "on"])
def test_span_and_stage_are_ranges_under_a_profiler(recording):
    def body():
        with profile.span("graph.replay"):
            with profile.stage("step.update"), profile.stage("update.ekf"):
                torch.ones(3).add_(1)

    with profile.recording(recording):
        ranges = _profiled_ranges(body)
    assert {"graph.replay", "step.update", "update.ekf"} <= set(ranges)
    assert _inside(ranges["update.ekf"][0], "step.update")
    assert _inside(ranges["step.update"][0], "graph.replay")
    got = profile.spans()
    assert [(s.name, s.profiled) for s in got] == ([("graph.replay", True)] if recording else [])


def test_live_frame_records_its_children_in_order(world):
    tc, seq, imgs = world
    vio = tint.VioInterface(tc, dtype=torch.float64, track_handler_kwargs=TH_KW, device="cpu")
    vio.initialize_from_ground_truth(**tp.INIT, b_g=seq.b_g, b_a=seq.b_a)
    K = seq.imu_omega.shape[1]
    with profile.recording():
        for i in range(3):
            for k in range(K):
                vio.imu_callback(seq.imu_omega[i, k], seq.imu_acc[i, k],
                                 float(seq.time[i]) - (K - 1 - k) * 0.005,
                                 dt=float(seq.imu_dt[i, k]))
            assert vio.image_callback(imgs[i], float(seq.time[i]))
    got = profile.spans()
    frames = [s for s in got if s.name == "live.frame"]
    assert [f.request for f in frames] == [1, 2, 3] and all(f.parent is None for f in frames)
    eager = ["live.drain", "live.stage", "live.copy_back", "live.unpack"]
    graphed = ["live.drain", "live.stage", "graph.load", "graph.replay", "live.copy_back",
               "live.unpack"]
    assert [_children(got, f) for f in frames] == [eager, graphed, graphed]
    for f in frames:
        kids = [s for s in got if s.parent == f.index]
        assert all(s.request == f.request for s in kids)
        assert f.start_ns <= kids[0].start_ns and kids[-1].end_ns <= f.end_ns
    imu = [s for s in got if s.name == "live.imu"]
    assert [s.request for s in imu] == [r for r in (1, 2, 3) for _ in range(K)]
    assert all(s.parent is None for s in imu)


@pytest.mark.parametrize("graphed", [True, False], ids=["static-buffers", "eager"])
def test_scan_records_each_step(graphed):
    def fn(carry, x):
        return carry + x, carry * 2

    with profile.recording(), (contextlib.nullcontext() if graphed else cuda_graph.disabled()):
        carry, ys = cuda_graph.scan(fn, torch.zeros(2), torch.ones(3, 2))
    assert torch.equal(carry, torch.full((2,), 3.0))
    assert torch.equal(ys[:, 0], torch.tensor([0.0, 2.0, 4.0]))
    got = profile.spans()
    steps = [s for s in got if s.name == "scan.step"]
    assert [s.request for s in steps] == [0, 1, 2] and all(s.parent is None for s in steps)
    want = ["scan.slice", "graph.load", "graph.replay", "scan.stack"] if graphed else ["scan.slice"]
    assert all(_children(got, s) == want for s in steps)
    assert all(s.request == st.request for st in steps for s in got if s.parent == st.index)


def _mid_step(fused):
    tc = _configs(fused)
    seq, frames, snaps = tp.port_snapshots(tc, 8, {6}, torch.float64)
    return tp.port_state(snaps[6]), tfilter.frame_at(frames, 6), tc


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "sequential"])
def test_filter_step_emits_its_stages(fused):
    state, frame, tc = _mid_step(fused)
    ranges = _profiled_ranges(lambda: tfilter.step(state, frame, tc))
    names = FILTER_STAGES + UPDATE_STAGES[fused]
    assert set(names) == set(ranges), sorted(ranges)
    assert all(len(v) == 1 for v in ranges.values())
    starts = [ranges[n][0].time_range.start for n in FILTER_STAGES]
    assert starts == sorted(starts)
    for n in FILTER_STAGES:
        assert not any(_inside(ranges[n][0], m) for m in FILTER_STAGES)
    for n in UPDATE_STAGES[fused]:
        assert _inside(ranges[n][0], "step.update")


def _frontend_inputs(world, B=2):
    tc, seq, imgs = world
    fcfg = tfunc.FrontendConfig(**FRONTEND)
    H, W = imgs.shape[1:]
    fstate = tfunc.init_frontend_state(H, W, fcfg, B, 1, torch.float64, device="cpu")
    img = torch.as_tensor(imgs[:1], dtype=torch.float64)
    dR = torch.eye(3, dtype=torch.float64).expand(B, 3, 3)
    return tc, fcfg, fstate, img, dR


def test_frontend_step_emits_its_stages(world):
    tc, fcfg, fstate, img, dR = _frontend_inputs(world)
    fstate, _ = tfunc.frontend_step(fstate, img, dR, tc, fcfg)
    ranges = _profiled_ranges(lambda: tfunc.frontend_step(fstate, img, dR, tc, fcfg))
    assert set(ranges) == set(FRONTEND_STAGES)
    starts = [ranges[n][0].time_range.start for n in FRONTEND_STAGES]
    assert starts == sorted(starts)


def test_pipeline_step_nests_the_frontend_under_step_frontend(world):
    tc, seq, imgs = world
    fcfg = tfunc.FrontendConfig(**FRONTEND)
    B = 2
    imu = ground_truth_init(**tp.INIT, b_g=seq.b_g, b_a=seq.b_a, dtype=torch.float64,
                            device="cpu")
    state = tmc.make_fleet(tc, imu, B, prng.PRNGKey(1), dtype=torch.float64, device="cpu")
    fstate = tfunc.init_frontend_state(*imgs.shape[1:], fcfg, B, 1, torch.float64, device="cpu")

    def b(x, dtype=torch.float64):
        return torch.as_tensor(np.asarray(x)).to(dtype).expand((B,) + np.asarray(x).shape)

    frame = tpipe.ImageFrameInput(
        image=torch.as_tensor(imgs[0:1], dtype=torch.float64), imu_omega=b(seq.imu_omega[0]),
        imu_acc=b(seq.imu_acc[0]), imu_dt=b(seq.imu_dt[0]), state_id=b(1, torch.int32),
        time=b(seq.time[0]), frame_valid=b(True, torch.bool))
    ranges = _profiled_ranges(lambda: tpipe.step((state, fstate), frame, tc, fcfg))
    assert set(ranges) == {"step.frontend", *FRONTEND_STAGES, *FILTER_STAGES,
                           *UPDATE_STAGES[False]}
    for n in FRONTEND_STAGES:
        assert _inside(ranges[n][0], "step.frontend")
    for n in FILTER_STAGES:
        assert not _inside(ranges[n][0], "step.frontend")


def test_live_frame_nests_the_image_steps_frontend_stages(world):
    tc, seq, imgs = world
    vio = tint.VioInterface(tc, dtype=torch.float64, track_handler_kwargs=TH_KW, device="cpu")
    vio.initialize_from_ground_truth(**tp.INIT, b_g=seq.b_g, b_a=seq.b_a)
    K = seq.imu_omega.shape[1]

    def frames(lo, hi):
        for i in range(lo, hi):
            for k in range(K):
                vio.imu_callback(seq.imu_omega[i, k], seq.imu_acc[i, k],
                                 float(seq.time[i]) - (K - 1 - k) * 0.005,
                                 dt=float(seq.imu_dt[i, k]))
            assert vio.image_callback(imgs[i], float(seq.time[i]))

    frames(0, 1)                      # the first image has nothing to track
    ranges = _profiled_ranges(lambda: frames(1, 3))
    assert {n for n in ranges if n.startswith("frontend.")} == set(FRONTEND_STAGES)
    assert len(ranges["step.frontend"]) == 2
    for n in FRONTEND_STAGES:
        assert len(ranges[n]) == 2 and all(_inside(e, "step.frontend") for e in ranges[n]), n


def _equal_trees(a, b, tag):
    la, sa = cuda_graph.flatten(a)
    lb, sb = cuda_graph.flatten(b)
    assert sa == sb, tag
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{tag}: leaf {i}"


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "sequential"])
def test_recording_leaves_the_static_buffer_path_bit_equal(fused):
    tc = _configs(fused)
    seq = tp.sequence(tc, 8)
    frames = tp.port_frames(seq, torch.float64, batch=2)

    def run():
        imu = ground_truth_init(**tp.INIT, b_g=seq.b_g, b_a=seq.b_a, dtype=torch.float64,
                                device="cpu")
        fleet = tmc.make_fleet(tc, imu, 2, prng.PRNGKey(1), dtype=torch.float64, device="cpu")
        return tfilter.run_sequence(fleet, frames, tc)

    off = run()
    with profile.recording():
        on = run()
    assert sum(s.name == "scan.step" for s in profile.spans()) == 8
    _equal_trees(on, off, "run_sequence, recording on against off")


def test_live_frames_bit_equal_with_recording_on_and_off(world):
    tc, seq, imgs = world

    def run():
        vio = tint.VioInterface(tc, dtype=torch.float64, track_handler_kwargs=TH_KW, device="cpu")
        vio.initialize_from_ground_truth(**tp.INIT, b_g=seq.b_g, b_a=seq.b_a)
        K, poses = seq.imu_omega.shape[1], []
        for i in range(T):
            for k in range(K):
                vio.imu_callback(seq.imu_omega[i, k], seq.imu_acc[i, k],
                                 float(seq.time[i]) - (K - 1 - k) * 0.005,
                                 dt=float(seq.imu_dt[i, k]))
            vio.image_callback(imgs[i], float(seq.time[i]))
            poses.append(vio.odometry()["p_I_G"].copy())
        return np.stack(poses), vio.state_to_numpy()

    off = run()
    with profile.recording():
        on = run()
    np.testing.assert_array_equal(on[0], off[0])
    for k, v in off[1].items():
        assert np.array_equal(on[1][k], v) if isinstance(v, np.ndarray) else on[1][k] == v, k


def test_cuda_build_counts_builds_and_cache_hits(tmp_path, monkeypatch):
    import shutil

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: shutil.which("true"))
    builds, hits = cuda_build.builds, cuda_build.cache_hits
    with profile.recording():
        path = cuda_build.build_library("psd_gamma")
        assert cuda_build.build_library("psd_gamma") == path
    assert path.exists() and path.parent == tmp_path
    assert (cuda_build.builds, cuda_build.cache_hits) == (builds + 1, hits + 1)
    got = profile.spans()
    assert [(s.name, s.attrs) for s in got] == [("build.nvcc", {"source": "psd_gamma"})]


def test_stage_timer_sums_its_recorder():
    timer = profile.StageTimer()
    for name in ("imu_prop", "update", "imu_prop"):
        with timer.stage(name, block=torch.ones(2)):
            pass
    summary = timer.summary()
    assert {k: v["calls"] for k, v in summary.items()} == {"imu_prop": 2, "update": 1}
    spans = timer.recorder.spans()
    assert len(spans) == 3 and profile.spans() == []
    total = sum(s.end_ns - s.start_ns for s in spans if s.name == "imu_prop") / 1e9
    assert summary["imu_prop"]["total_s"] == round(total, 4)
