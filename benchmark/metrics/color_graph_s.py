"""`color_graph_s`: the port's `stage_seconds["color_graph"]` summed over the window's calls, a call."""


def read(run: dict):
    s = run["stage_sums"].get("color_graph")
    return None if s is None or not run["calls"] else s / run["calls"]
