"""ransac_device_ms.<kind>: device time a frame, in ms, of the operations
launched inside the program's ``frontend.ransac`` range
(``frontend/track_handler``: the two undistorts, the key split, the draw of
the hypotheses' pairs and their scoring, and RANSAC's counters), over the
traced run's eager frames, each device event matched to its launch by the
profiler's correlation id. Read where the traffic's run splits the eager
frames by stage (``Trace.stage_ms``, ``harness/live_ransac.py``)."""


def read(run, variant):
    tr = run.get("trace")
    if tr is None or variant != run["kind"]:
        return None
    split = getattr(tr, "stage_ms", None) or {}
    if "frontend.ransac" not in split:
        return None
    return split["frontend.ransac"][0]
