"""gamma_roofline.<kind>: the gamma kernel's share of its roofline, in %: the
sum of its launches' bounds over the sum of their device times, over the
launches of the traced run's recorded steps (harness/kernels.py)."""


def read(run, variant):
    if variant != run["kind"] or "gamma" not in run.get("shares", {}):
        return None
    return 100.0 * run["shares"]["gamma"][0]
