"""`load_table_s`: the port's `stage_seconds["load_table"]` summed over the window's calls, a call."""


def read(run: dict):
    s = run["stage_sums"].get("load_table")
    return None if s is None or not run["calls"] else s / run["calls"]
