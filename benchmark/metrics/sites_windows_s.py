"""`sites_windows_s`: the port's `stage_seconds["window_coverage"]` summed over the window's calls, a call."""


def read(run: dict):
    s = run["stage_sums"].get("window_coverage")
    return None if s is None or not run["calls"] else s / run["calls"]
