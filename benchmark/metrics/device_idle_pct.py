"""`device_idle_pct`: 100 - the card's busy share of the profiled call
(union of its kernels, copies and memsets; benchmark/profiles.py), when
the profile holds every launch of the hand-written kernels."""


def read(run: dict):
    prof = run.get("profile")
    return None if prof is None else prof["idle_pct"]
