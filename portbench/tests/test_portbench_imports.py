"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference takes nothing of the program."""

import ast
import subprocess
import sys

from tiny import ROOT

BENCH = ROOT / "portbench"
# The program's modules a run drives.
PROGRAM = ["msckf_mono_tpu_torch.interface", "msckf_mono_tpu_torch.core.pipeline",
           "msckf_mono_tpu_torch.parallel.sharding", "msckf_mono_tpu_torch.parallel.montecarlo",
           "msckf_mono_tpu_torch.ops.psd_cuda", "msckf_mono_tpu_torch.ops.fast_cuda",
           "msckf_mono_tpu_torch.ops.klt_cuda"]


def _modules():
    out = []
    for path in sorted(BENCH.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts:
            continue
        out.append(".".join(p for p in rel.parts if p != "__init__"))
    return out


def test_no_jax_in_the_benchmark_process():
    code = (
        "import importlib, runpy, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"runpy.run_path({str(BENCH / 'run.py')!r}, run_name='portbench_import_check')\n"
        f"for m in {_modules() + PROGRAM!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'msckf_mono_tpu'})\n"
        "assert 'msckf_mono_tpu_torch' in {m.split('.')[0] for m in sys.modules}\n"
        "print('BAD', bad)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "BAD []" in res.stdout, res.stdout


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("msckf_mono_tpu_torch", "msckf_mono_tpu", "jax", "jaxlib",
                                   "flax"), f"{path}: imports {name}"
                if top == "portbench":
                    assert name.startswith(("portbench.reference", "portbench.harness.cell")), \
                        f"{path}: imports {name}"
