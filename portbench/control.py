"""The control of ``correct``, and the sound readings its limits are set from.

    python portbench/control.py --workload <cell> --seeds 11,12,13 [--seconds 20]
        [--witness-seeds 12] [--witness-above 0.02] [--dump DIR] [--numbers a,b]

For each seed it makes the cell's traffic as a run does, has the program
serve the rows a run compares once, outside a timed window (the driver's
``served_once``), and runs the float64 reference on the same inputs. It
prints each number a run compares for:

- ``program``: the program as the configuration states it, the sound reading;
- ``control``: what the traffic file's ``check.control`` names, one step
  below the configuration's precision. ``{"program": {group: {key: value}}}``
  is the program's own path of that precision, switched on in the
  configuration (the image products at TF32); ``{"reference": {"dtype":
  "float32", "tf32": true}}`` is the plain reference put in the program's
  place at that precision, where the program has no such path;
- ``witness`` (the ``--witness-seeds``, and any seed whose sound widest gap
  reads above ``--witness-above`` metres): the plain reference in float32
  with TF32 off, a second witness of what float32 alone does to the number;
  and, for each row whose sound gap is the widest, the first frame at which
  its decisions (features residualized; gating, motion and triangulation
  rejects) part from the float64 reference's, in the program and in the
  witness.

``--dump`` writes each seed's positions and decisions to ``DIR``. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from portbench.harness import cell as cellmod  # noqa: E402


def _first_nonfinite(served):
    return min((int(np.isfinite(s).all(-1).argmin()) if not np.isfinite(s).all() else s.shape[0])
               for s in served)


def _parting(a, b):
    """The first frame at which decision trails a and b ((T, 4)) differ, and
    the counts there; None where they never do."""
    from portbench.reference.runner import DECISIONS

    diff = np.nonzero((a != b).any(-1))[0]
    if not diff.size:
        return None
    t = int(diff[0])
    return {"frame": t, **{k: [int(a[t, i]), int(b[t, i])] for i, k in enumerate(DECISIONS)
                           if a[t, i] != b[t, i]}}


def readings(cell, seed, seconds, dev, witness=False, witness_above=None, dump=None,
             names=None):
    """One seed's readings of the numbers ``names`` (all the cell compares,
    by default)."""
    import torch

    from portbench.reference import compare

    log = cellmod.log
    driver = cell.driver()
    names = list(names or cell.traffic["check"]["limits"])
    positions = "pos_gap_m" in names
    spec = cell.traffic["check"]["control"]
    t0 = time.perf_counter()
    out = driver.served_once(cell, seed, dev, log, seconds)
    ref = driver.reference(out, cell, dev, torch.float64, positions=positions)
    r = {"seed": seed, "rows": len(out["served"]), "program": compare.numbers(out, ref, names)}
    if "program" in spec:
        ctl = driver.served_once(cell.with_config(spec["program"]), seed, dev, log, seconds)
        r["control_is"] = f"the program with {json.dumps(spec['program'])}"
    else:
        low = spec["reference"]
        lo = driver.reference(out, cell, dev, cellmod.dtype_of(low), tf32=bool(low["tf32"]),
                              positions=positions)
        ctl = {}
        if positions:
            ctl["served"] = [lo["p"][: s.shape[0], i] for i, s in enumerate(out["served"])]
        if "pyramids" in lo:
            ctl["pyramids"] = [(f, lv) for (f, _), lv in zip(out["pyramids"], lo["pyramids"])]
        r["control_is"] = f"the reference in {low['dtype']}, TF32 {'on' if low['tf32'] else 'off'}"
    r["control"] = compare.numbers(ctl, ref, names)
    if not positions:
        r["seconds"] = time.perf_counter() - t0
        return r
    served_c = ctl["served"]
    bad = _first_nonfinite(served_c)
    r["control_first_nonfinite_frame"] = bad
    r["control_before_it"] = compare.numbers({"served": [s[:bad] for s in served_c]}, ref,
                                             ["pos_gap_m"])
    arrays = {"served": np.stack(out["served"], 1), "control": np.stack(served_c, 1),
              "ref": ref["p"], "ref_decisions": ref["decisions"]}
    gaps = compare.row_gaps(out["served"], ref["p"])
    worst = int(np.argmax([g.max(initial=0.0) for g in gaps]))
    r["widest_row"] = {"row": worst, "frame": int(np.argmax(gaps[worst]))}
    if "num_residualized" in out:
        arrays["served_num_residualized"] = out["num_residualized"]
        parted = np.nonzero(out["num_residualized"][:, worst] != ref["decisions"][:, worst, 0])[0]
        r["widest_row"]["program_residualized_parts_at"] = int(parted[0]) if parted.size else None
    if witness or (witness_above is not None and r["program"]["pos_gap_m"] > witness_above):
        w = driver.reference(out, cell, dev, torch.float32, tf32=False)
        wout = {"served": [w["p"][: s.shape[0], i] for i, s in enumerate(out["served"])]}
        r["witness"] = compare.numbers(wout, ref, ["pos_gap_m"])
        r["widest_row"]["witness_parts_at"] = _parting(w["decisions"][:, worst],
                                                       ref["decisions"][:, worst])
        arrays.update(witness=w["p"], witness_decisions=w["decisions"])
    if dump is not None:
        dump.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(dump / f"{cell.name}.{seed}.npz", **arrays)
    r["seconds"] = time.perf_counter() - t0
    return r


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--witness-seeds", default="")
    p.add_argument("--witness-above", type=float)
    p.add_argument("--dump", type=Path)
    p.add_argument("--numbers", default="", help="comma-separated; all the cell compares by "
                   "default (pos_gap_m runs the whole reference)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = cellmod.find_cell(args.workload)
    if args.device == "cuda":
        cellmod.require_chips(cell.chips)
    dev = cellmod.Device(args.device)
    witness = {int(s) for s in args.witness_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(cell, seed, args.seconds, dev, seed in witness, args.witness_above, args.dump,
                     [n for n in args.numbers.split(",") if n])
        r.update(workload=cell.name, card=cellmod.clocks(dev))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
