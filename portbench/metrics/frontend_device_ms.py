"""frontend_device_ms.<kind>: device time a step, in ms, of the operations
launched inside the program's ``step.frontend`` range (``core/pipeline.step``:
the gyro warp, pyramid, KLT, FAST and detection, dedup and the feature
budget), over the traced run's eager steps, each device event matched to its
launch by the profiler's correlation id. Read where the traffic's run splits the
eager steps by stage (``Trace.stage_ms``, ``harness/fleet_indep.py``)."""


def read(run, variant):
    tr = run.get("trace")
    if tr is None or variant != run["kind"]:
        return None
    split = getattr(tr, "stage_ms", None) or {}
    if "step.frontend" not in split:
        return None
    return split["step.frontend"][0]
