"""The port's ``eval/timing.py`` and ``eval/profile.py`` against the JAX package's, on the CPU.

* ``STAGES`` equals JAX's;
* ``stage_timing`` returns a positive time for every stage, and with
  ``cost=True`` (seconds, flops, bytes accessed) with positive bytes and
  the matrix products' flops, and leaves the launch counts as they were;
* ``StageTimer.summary()`` has JAX's keys and counts;
* ``trace`` writes a Chrome trace under its logdir.
"""

import json

import pytest
import torch

from msckf_mono_tpu.eval import profile as jprofile
from msckf_mono_tpu.eval import timing as jtiming
from msckf_mono_tpu_torch.core import augment, tracks
from msckf_mono_tpu_torch.core import filter as tfilter
from msckf_mono_tpu_torch.eval import profile as tprofile
from msckf_mono_tpu_torch.eval import timing as ttiming
from msckf_mono_tpu_torch.ops import cuda_graph

from tests import _torch_port as tp


def test_stages_equal_jax():
    assert ttiming.STAGES == jtiming.STAGES


@pytest.fixture(scope="module")
def mid():
    """bench.py --stages' inputs at the tiny shapes: a mid-sequence state
    propagated, augmented and updated by one frame, that frame, and the
    tracks it staged."""
    _, tc = tp.configs(tp.TINY_FILTER, tp.TINY_SHAPES)
    seq, frames, snaps = tp.port_snapshots(tc, 10, {8}, torch.float64)
    f = tfilter.frame_at(frames, 8)
    s = tfilter.propagate_block(tp.port_state(snaps[8]), f, tc)
    s = augment.augment_state(s, f.state_id, f.time, tc)
    s, staged = tracks.update_tracks(s, f.tracked_uv, f.tracked_ids, f.tracked_valid, tc)
    return s, f, staged, tc


@pytest.mark.parametrize("cost", [False, True], ids=["time", "cost"])
def test_stage_timing_times_every_stage(mid, cost):
    state, frame, staged, tc = mid
    before = cuda_graph.counts()
    table = ttiming.stage_timing(state, frame, staged, tc, reps=4, cost=cost)
    assert tuple(table) == jtiming.STAGES
    assert cuda_graph.counts() == before
    for name, row in table.items():
        if cost:
            seconds, flops, nbytes = row
            assert flops >= 0 and nbytes > 0, name
        else:
            seconds = row
        assert seconds > 0, name
    if cost:
        assert table["full_step"][1] > table["marginalize"][1] > 0
        assert table["full_step"][2] > table["imu_prop"][2]


def test_stage_timer_summary_has_jax_keys():
    summaries = []
    for timer in (jprofile.StageTimer(), tprofile.StageTimer()):
        for name in ("imu_prop", "update", "imu_prop"):
            with timer.stage(name, block=None if isinstance(timer, jprofile.StageTimer)
                             else torch.ones(2)):
                pass
        summaries.append(timer.summary())
    jsum, tsum = summaries
    assert set(tsum) == set(jsum)
    for k in jsum:
        assert set(tsum[k]) == set(jsum[k]) and tsum[k]["calls"] == jsum[k]["calls"]


def test_trace_writes_under_its_logdir(tmp_path):
    logdir = tmp_path / "trace"
    with tprofile.trace(str(logdir)) as d:
        torch.ones(8) @ torch.ones(8)
    assert d == str(logdir)
    trace = json.loads((logdir / "trace.json").read_text())
    assert trace["traceEvents"]
    assert tprofile.trace.last is not None
