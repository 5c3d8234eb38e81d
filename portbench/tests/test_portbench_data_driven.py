"""A configuration, a traffic mix, a cell, a per-layer metric and a driver
of a new kind of traffic are added with new files and new entries alone:
the harness finds them by name, and no file it already had changes."""

import hashlib
import json

from tiny import last_line, make_tiny, run_cpu


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_and_entries_only(tmp_path):
    root = make_tiny(tmp_path / "bench")
    before = _digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())

    cfg = json.loads((root / "portbench/configs/euroc-serving.json").read_text())
    cfg.update(name="euroc-serving-dummy", staged_chunk_rows=4096)
    (root / "portbench/configs/euroc-serving-dummy.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "portbench/traffic/mc_jobs_tracks.json").read_text())
    tr.update(batch=2, frames=8)
    (root / "portbench/traffic/dummy_jobs.json").write_text(json.dumps(tr))
    (root / "portbench/metrics/dummy_frames.py").write_text(
        "def read(run, variant):\n"
        "    return float(run['attempted']) if variant == run['kind'] else None\n")

    bench["configs"].append({"name": "euroc-serving-dummy", "source": "https://example.org/dummy",
                             "file": "portbench/configs/euroc-serving-dummy.json",
                             "reduced": [], "why": "a dummy"})
    bench["workloads"].append({"name": "dummy-b2", "config": "euroc-serving-dummy",
                               "traffic": "dummy_jobs", "chips": 1, "why": "a dummy"})
    bench["end_to_end"][1]["workloads"].append("dummy-b2")
    bench["per_layer"].append({"name": "dummy_frames.track", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "Step",
                               "moves": "track_frames_per_s", "workloads": ["dummy-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    for trace in (0, 1):
        rc, out, err = run_cpu(root, ["--workload", "dummy-b2", "--seed", "3", "--seconds", "0.3",
                                      "--trace", str(trace)])
        assert rc == 0, err[-3000:]
        res = last_line(out)
        assert res["correct"] is True
        if trace:
            assert res["metrics"]["dummy_frames.track"]["value"] == res["attempted"]
        else:
            assert set(res["metrics"]) == {"setup_s", "track_frames_per_s"}
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


# A driver of traffic that no existing driver serves: tracks in which no new
# feature appears after the sequence's first half. The program serves it and
# the reference runs on the same, changed, sequence.
NEW_DRIVER = """
from portbench.harness import fleet


class NoLateFeatures(fleet.TrackRun):
    def _frames(self, w, common):
        self.seq.new_valid[self.T // 2:] = False
        return super()._frames(w, common)


INPUTS = {"tracks_no_late_features": NoLateFeatures}


def serve(*args):
    return fleet.serve(*args, inputs=INPUTS)


def served_once(*args):
    return fleet.served_once(*args, inputs=INPUTS)


reference = fleet.reference
"""


def test_new_driver_and_traffic_kind(tmp_path):
    root = make_tiny(tmp_path / "bench")
    before = _digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "portbench/harness/fleet_no_late.py").write_text(NEW_DRIVER)
    tr = json.loads((root / "portbench/traffic/mc_jobs_tracks.json").read_text())
    tr.update(driver="fleet_no_late", input="tracks_no_late_features", batch=2, frames=8)
    (root / "portbench/traffic/no_late_jobs.json").write_text(json.dumps(tr))
    bench["workloads"].append({"name": "no-late-b2", "config": "euroc-serving",
                               "traffic": "no_late_jobs", "chips": 1, "why": "a dummy"})
    bench["end_to_end"][1]["workloads"].append("no-late-b2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, out, err = run_cpu(root, ["--workload", "no-late-b2", "--seed", "4", "--seconds", "0.3",
                                  "--trace", "0"])
    assert rc == 0, err[-3000:]
    res = last_line(out)
    assert res["correct"] is True and set(res["metrics"]) == {"setup_s", "track_frames_per_s"}
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_fleet_refuses_an_unknown_input(tmp_path):
    root = make_tiny(tmp_path / "bench")
    path = root / "portbench/traffic/mc_jobs_tracks.json"
    tr = json.loads(path.read_text())
    tr["input"] = "images_indep"
    path.write_text(json.dumps(tr))
    rc, out, err = run_cpu(root, ["--workload", "tracks-b1024", "--seed", "4", "--seconds", "0.3",
                                  "--trace", "0"])
    assert rc != 0 and '"correct"' not in out
    assert "fleet traffic input 'images_indep'" in err
