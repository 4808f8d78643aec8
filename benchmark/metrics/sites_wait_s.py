"""`sites_wait_s`: the port's `stage_seconds["coverage_wait"]` summed over the window's calls, a call."""


def read(run: dict):
    s = run["stage_sums"].get("coverage_wait")
    return None if s is None or not run["calls"] else s / run["calls"]
