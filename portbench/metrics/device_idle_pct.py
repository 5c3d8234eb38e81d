"""device_idle_pct.<kind>: the share of the traced steps' wall time in which
no operation ran on the device: the union of the device's events against the
steps' own wall time (the fleets: the profiled steps from the first launch to
the sync after the last; the live stream: each frame's service, from its due
time to its pose on the host, so that arrival gaps are left out).

It includes the profiler's own cost: under CUPTI the host's launch of a
replayed graph is slower (a traced tracks step 52.8-53.1 ms against 50.9 ms
untraced on an H100), and that time shows as idle. It compares traced runs
with traced runs, never with an untraced step."""


def read(run, variant):
    tr = run.get("trace")
    if tr is None or variant != run["kind"] or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
