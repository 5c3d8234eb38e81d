"""A run with the timed path broken underneath comes out not correct: the
chip's look is skipped (the CPU), the rest of a run is driven as on the chip.

The faults a fleet cell can have (on tracks and on the shared camera, whose
pipeline step runs the same filter step): a step that returns its state
unchanged; half of the batch left out; an answer altered where it is
produced. A live cell: the first and the last (it serves one filter, so no
half of a batch).
No cell exchanges anything between chips."""

import json

import pytest

from tiny import last_line, make_tiny, run_cpu, with_traffic

PATCH = """
import torch
from msckf_mono_tpu_torch.core import filter as _f
from msckf_mono_tpu_torch.core.types import tree_where
_orig = _f.step

def _broken(state, frame, config):
    new, out = _orig(state, frame, config)
    B = state.P.shape[0]
    if FAULT == "unchanged":
        return state, out.replace(p_I_G=state.imu.p_I_G.clone())
    if FAULT == "half":
        keep = torch.arange(B, device=state.P.device) < B // 2
        return (tree_where(keep, new, state),
                out.replace(p_I_G=torch.where(keep[:, None], out.p_I_G, state.imu.p_I_G)))
    # the position a fleet serves (the frame's output) and the one the live
    # interface serves (the state's), altered on one frame
    bump = (frame.state_id == 3).to(out.p_I_G.dtype)[:, None] * BUMP
    new = new.replace(imu=new.imu.replace(p_I_G=new.imu.p_I_G + bump))
    return new, out.replace(p_I_G=out.p_I_G + bump)

_f.step = _broken
"""


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = make_tiny(tmp_path_factory.mktemp("bench"))
    # long enough (2 s of motion) that a state left unchanged, or half of
    # the fleet, falls behind the world by more than the cell's limit
    with_traffic(root, "mc_jobs_images_shared", frames=40)
    return root


def _limit(root, traffic):
    with open(root / "portbench" / "traffic" / f"{traffic}.json") as f:
        return json.load(f)["check"]["limits"]["pos_gap_m"]


@pytest.mark.parametrize("workload,traffic,fault", [
    ("tracks-b1024", "mc_jobs_tracks", "unchanged"),
    ("tracks-b1024", "mc_jobs_tracks", "half"),
    ("tracks-b1024", "mc_jobs_tracks", "altered"),
    ("images-shared-b256", "mc_jobs_images_shared", "unchanged"),
    ("images-shared-b256", "mc_jobs_images_shared", "half"),
    ("images-shared-b256", "mc_jobs_images_shared", "altered"),
    ("live-b1-20hz", "live_stream_20hz", "unchanged"),
    ("live-b1-20hz", "live_stream_20hz", "altered"),
])
def test_fault_is_not_correct(tiny, workload, traffic, fault):
    prelude = f"FAULT = {fault!r}\nBUMP = {2 * _limit(tiny, traffic)!r}\n" + PATCH
    # the shared camera's cut cell serves a few frames a second on the CPU:
    # a window of 6 s serves 2 s of motion
    seconds = "6" if traffic == "mc_jobs_images_shared" else "0.5"
    rc, out, err = run_cpu(tiny, ["--workload", workload, "--seed", "77", "--seconds", seconds,
                                  "--trace", "0"], prelude=prelude)
    assert rc == 0, err[-3000:]
    res = last_line(out)
    assert res["correct"] is False, res["check"]
