"""`k1_roofline_pct`: K1's share of its bytes bound over the profiled
call (benchmark/profiles.py), when the profile holds every launch."""


def read(run: dict):
    prof = run.get("profile")
    return None if prof is None else prof["k1_roofline_pct"]
