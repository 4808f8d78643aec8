"""`search_s`: the port's `stage_seconds["search"]` summed over the window's calls, a call."""


def read(run: dict):
    s = run["stage_sums"].get("search")
    return None if s is None or not run["calls"] else s / run["calls"]
