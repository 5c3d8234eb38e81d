"""Rehearsals of every cell on the CPU, cut small: the last line's keys and
the numbers compared, each beside its limit."""

import pytest

from tiny import last_line, make_tiny, run_cpu


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload,trace", [("tracks-b1024", 0), ("tracks-b1024", 1),
                                            ("images-shared-b256", 0), ("live-b1-20hz", 0)])
def test_last_line(tiny, workload, trace):
    rc, out, err = run_cpu(tiny, ["--workload", workload, "--seed", str(2**31 + 12345),
                                  "--seconds", "0.5", "--trace", str(trace)])
    assert rc == 0, err[-3000:]
    res = last_line(out)
    assert list(res)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    names = set(res["metrics"])
    if trace:
        assert "capture_s" in names and "setup_s" not in names
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in names and len(names) >= 2
    # the numbers compared are the last lines of standard error (before the
    # rehearsal's own MODULES line)
    last = err.strip().splitlines()[-1 - len(res["check"]):-1]
    for name, c in res["check"].items():
        assert c["value"] <= c["limit"]
        assert f"{name} {c['value']!r} limit {c['limit']!r}" in last
    assert "'jax'" not in err and "'msckf_mono_tpu'" not in err


def test_no_result_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    gives no result."""
    import shutil

    from tiny import ROOT

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    rc, out, _ = run_cpu(tmp_path, ["--workload", "tracks-b1024", "--seed", "1",
                                    "--seconds", "0.5", "--trace", "0"])
    assert rc != 0 and '"correct"' not in out


def test_no_result_with_jax_loaded(tiny):
    rc, out, err = run_cpu(tiny, ["--workload", "tracks-b1024", "--seed", "5", "--seconds", "0.5",
                                  "--trace", "0"],
                           prelude="import types\nsys.modules['jax'] = types.ModuleType('jax')")
    assert rc != 0 and '"correct"' not in out and "jax" in err
