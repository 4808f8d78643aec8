"""`sites_write_s`: the port's `stage_seconds["write_tables"]` summed over the window's calls, a call."""


def read(run: dict):
    s = run["stage_sums"].get("write_tables")
    return None if s is None or not run["calls"] else s / run["calls"]
