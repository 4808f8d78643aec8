"""`unstaged_s`: the port's `stage_seconds["unstaged"]` summed over the window's calls, a call."""


def read(run: dict):
    s = run["stage_sums"].get("unstaged")
    return None if s is None or not run["calls"] else s / run["calls"]
