"""The benchmark of the PyTorch and CUDA port, ``msckf_mono_tpu_torch``: one run of one cell.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The cell, its configuration file and its traffic file are found by name from
``BENCHMARK.json``; the traffic's ``driver``, the module
``portbench/harness/<driver>.py``, serves it and runs the reference over
what it served; each per-layer metric is read by
``portbench/metrics/<name before the first dot>.py``. After the window the
plain reference (``portbench/reference``) runs on the same inputs, and the
comparison decides ``correct``. The last line of standard output is the
result; the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import cell as cellmod  # noqa: E402

REFERENCE_DTYPE = "float64"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fixed_caches(root: Path):
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own kernel libraries live in ``msckf_mono_tpu_torch/build``)."""
    cache = root / ".portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def main(argv=None, device="cuda", root: Path = ROOT):
    """One run; ``device="cpu"`` is for the CPU tests alone, which drive the
    harness without a chip."""
    clock = cellmod.Clock()
    args = parse(argv)
    cell = cellmod.find_cell(args.workload, root)
    if device == "cuda":
        cellmod.require_chips(cell.chips)
    fixed_caches(root)
    dev = cellmod.Device(device)
    log = cellmod.log
    import torch

    torch.backends.cuda.matmul.allow_tf32 = bool(cell.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cell.config["tf32"])
    log(f"[run] {cell.name}: seed {args.seed}, {args.seconds:g} s, trace {args.trace}; "
        f"{cellmod.clocks(dev)}; {cellmod.placement(dev)}")
    driver = cell.driver()
    out = driver.serve(cell, args, dev, clock, log)
    log(f"[card] before the window: {out['clocks_before']}; after: {out['clocks_after']}")
    log(f"[set-up] {out['setup_s']:.3f} s, of which the first call (capture) "
        f"{out['capture_s']:.3f} s; peak memory {out['device']['memory_peak_bytes']} bytes")

    if args.trace:
        metrics, device_info = {}, dict(out["device"])
        for m in cell.metrics("per_layer"):
            base, _, variant = m["name"].partition(".")
            reader = importlib.import_module(f"portbench.metrics.{base}")
            value = reader.read(out, variant or None)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = out.get("trace")
        if tr is not None:
            device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
            breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        for k, (share, n) in sorted(out.get("shares", {}).items()):
            log(f"[kernels] {k}: {100 * share:.4f}% of its roofline over {n} launches "
                f"(card: {out['clocks_before']})")
    else:
        metrics = {"setup_s": {"value": out["setup_s"], "unit": "s"}}
        for m in cell.metrics("end_to_end"):
            if m["name"] != "setup_s":
                metrics[m["name"]] = {"value": out["metrics"][m["name"]], "unit": m["unit"]}
        device_info = out["device"]

    t0 = time.perf_counter()
    ref = driver.reference(out, cell, dev, cellmod.dtype_of({"dtype": REFERENCE_DTYPE}))
    from portbench.reference import compare

    limits = cell.traffic["check"]["limits"]
    checks, correct = compare.verdict(compare.numbers(out, ref, limits), limits)
    log(f"[check] the reference ({REFERENCE_DTYPE}, plain, eager) took "
        f"{time.perf_counter() - t0:.2f} s for {ref['p'].shape[1]} rows x {ref['p'].shape[0]} "
        f"frames")

    found = cellmod.forbidden_modules()
    if found:
        log(f"[run] refused: the process holds {', '.join(found)}")
        return 3
    for name, c in checks.items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device_info}
    if args.trace and out.get("trace") is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": v["value"] if math.isfinite(v["value"]) else str(v["value"]),
                           "limit": v["limit"]} for k, v in checks.items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
