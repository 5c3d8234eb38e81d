"""Two processes joined by torch.distributed into one sharded fleet, as
tests/test_multiprocess.py drives tools/run_two_host_sim.py for JAX.

``python -m msckf_mono_tpu_torch.parallel.two_host_sim --cpu`` starts two
worker processes (gloo, two CPU shards each, a free port) and a one-process
run of the same four-shard layout. Its last line must say ``ok``: the ranks
agree exactly, totals equal the one-process run's, means within 1e-6
relative, and each process's fleet saved mid-sequence, restored and resumed
equals its uninterrupted run bit for bit.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_fleet_matches_one_process():
    proc = subprocess.run(
        [sys.executable, "-u", "-m", "msckf_mono_tpu_torch.parallel.two_host_sim", "--cpu",
         "--timeout", "300"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["ok"] is True, rec["checks"]
    assert all(rec["checks"].values()) and set(rec["checks"]) == {
        "ranks_agree", "totals_equal", "means_within_1e-6", "restored_equal", "resumed_equal"}
    assert rec["metrics"]["total_residualized"] > 0
    w0, w1 = rec["workers"]
    assert (w0["rank"], w0["shards"], w1["rank"], w1["shards"]) == (0, [0, 1], 1, [2, 3])
    assert w0["backend"] == w1["backend"] == "gloo"
    assert rec["reference"]["shards"] == [0, 1, 2, 3]
