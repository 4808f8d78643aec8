"""`sites_align_s`: the port's `stage_seconds["align"]` summed over the window's calls, a call."""


def read(run: dict):
    s = run["stage_sums"].get("align")
    return None if s is None or not run["calls"] else s / run["calls"]
