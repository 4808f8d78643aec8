"""`finalize_s`: the port's `stage_seconds["finalize"]` summed over the window's calls, a call:
on a group, rank 0's `finalize` span (parallel/sharded.py), the histogram's `all_reduce` and
every shard sent to rank 0's host and merged there."""


def read(run: dict):
    s = run["stage_sums"].get("finalize")
    return None if s is None or not run["calls"] else s / run["calls"]
