"""`graph_d2h_s`: the port's `stage_seconds["table_d2h"]` summed over the window's calls, a call."""


def read(run: dict):
    s = run["stage_sums"].get("table_d2h")
    return None if s is None or not run["calls"] else s / run["calls"]
