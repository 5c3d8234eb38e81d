"""A tiny copy of the benchmark for the CPU tests: the harness's code, the
program linked in, and cells cut to a few filters, frames and a 188 x 120
camera, found by name as the real ones are."""

from __future__ import annotations

import copy
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SMALL_CAMERA = dict(f_u=458.654 / 4, f_v=457.296 / 4, c_u=367.215 / 4, c_v=248.375 / 4,
                    width=188, height=120)


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_tiny(dst: Path, small: bool = True) -> Path:
    """``dst`` holding portbench (copied), the program (linked) and a
    BENCHMARK.json with the real cells; ``small`` cuts them to a few
    filters and frames on a 188 x 120 camera. Returns ``dst``."""
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dst / "msckf_mono_tpu_torch").symlink_to(ROOT / "msckf_mono_tpu_torch")
    bench = _load(ROOT / "BENCHMARK.json")
    _dump(bench, dst / "BENCHMARK.json")
    if not small:
        return dst
    for c in bench["configs"]:
        cfg = _load(ROOT / c["file"])
        cfg["filter_config"]["camera"].update(SMALL_CAMERA)
        if "track_handler" in cfg:
            cfg["track_handler"]["max_features"] = 32
        _dump(cfg, dst / c["file"])
    for w in bench["workloads"]:
        tr = _load(ROOT / "portbench" / "traffic" / f"{w['traffic']}.json")
        tr.update(batch=3, frames=12, chunk_frames=4, warmup_frames=6)
        if tr["driver"] == "live":
            tr.pop("batch"), tr.pop("frames"), tr.pop("chunk_frames")
        tr["trace"] = dict(from_frame=4, steps=2, kernel_steps=1)
        tr.setdefault("check", {})["filters"] = 3
        _dump(tr, dst / "portbench" / "traffic" / f"{w['traffic']}.json")
    return dst


def run_cpu(root: Path, argv, prelude: str = "", timeout: float = 600):
    """The harness's main on the CPU, in a process of its own started from
    ``root`` as a chip run is, after ``prelude`` (Python source). Returns
    (exit code, standard output, standard error)."""
    code = (f"import sys\nsys.path.insert(0, {str(root)!r})\n"
            "import torch\ntorch.set_num_threads(1)\n" + prelude +
            "\nfrom pathlib import Path\nfrom portbench import run\n"
            f"rc = run.main({list(argv)!r}, device='cpu', root=Path({str(root)!r}))\n"
            "print('MODULES', sorted({m.split('.')[0] for m in sys.modules}), file=sys.stderr)\n"
            "sys.exit(rc)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=timeout, cwd=root)
    return res.returncode, res.stdout, res.stderr


def last_line(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def with_traffic(root: Path, traffic: str, **changes):
    """Rewrite one traffic file of a tiny copy."""
    path = root / "portbench" / "traffic" / f"{traffic}.json"
    tr = copy.deepcopy(_load(path))
    tr.update(changes)
    _dump(tr, path)
