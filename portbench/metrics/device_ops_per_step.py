"""device_ops_per_step.<kind>: device operations (kernels, copies, sets) a
traced step runs: a fleet's frame step or a live frame."""


def read(run, variant):
    tr = run.get("trace")
    if tr is None or variant != run["kind"] or not tr.steps or not tr.device:
        return None
    return tr.ops() / tr.steps
