# Copied from ploidyfrost_tpu/kmer/cutoffs.py; imports point at this package.
"""Coverage cutoff selection from a k-mer histogram.

Exact ports of the reference's threshold heuristics:
  * cutoff_lower  == cutoffL (src/Main.cpp:200-235): first valley of the
    histogram (first index where count rises), returns
    round(1.25 * (valley_index - 1)); callers clamp to >= 10
    (src/Main.cpp:356, 728).
  * cutoff_upper  == cutoffH (src/Main.cpp:236-277): coverage where the
    cumulative count (with bin 1's mass as baseline) exceeds the
    `frequency` quantile (default 0.998).

Both operate on "<cov>\\t<count>" histogram lines (KMC transform
histogram format).
"""

from __future__ import annotations


def _parse_hist_lines(lines) -> list[int]:
    counts = []
    for s in lines:
        s = s.rstrip("\n")
        if not s:
            continue
        pos = s.find("\t")
        if pos < 0:
            raise ValueError("Histogram file is badly formatted.")
        counts.append(int(float(s[pos + 1 :].split("\t")[0].strip() or 0)))
    return counts


def cutoff_lower_from_counts(counts: list[int]) -> int:
    # first index (1-based scan) where the histogram starts rising
    peak = 1
    while peak < len(counts):
        if counts[peak - 1] < counts[peak]:
            break
        peak += 1
    # C++ round() rounds half away from zero
    x = 1.25 * (peak - 1)
    return int(x + 0.5) if x >= 0 else -int(-x + 0.5)


def cutoff_upper_from_counts(counts: list[int], frequency: float = 0.998) -> int:
    if len(counts) + 1 <= 2:
        raise ValueError("Histogram file is badly formatted.")
    cum = [0]
    for c in counts:
        cum.append(c + cum[-1])
    cf = frequency * (cum[-1] - cum[1]) + cum[1]
    peak = 2
    while peak < len(cum):
        if cum[peak] > cf:
            break
        peak += 1
    return peak


def _open_hist(path: str):
    try:
        return open(path)
    except OSError:
        # reference message: src/Main.cpp:204-208
        raise SystemExit(f"ERROR:Open Histogram File {path} error!")


def cutoff_lower(path: str) -> int:
    with _open_hist(path) as f:
        try:
            return cutoff_lower_from_counts(_parse_hist_lines(f))
        except ValueError as e:
            raise SystemExit(f"Error: {e}")


def cutoff_upper(path: str, frequency: float = 0.998) -> int:
    with _open_hist(path) as f:
        try:
            return cutoff_upper_from_counts(_parse_hist_lines(f), frequency)
        except ValueError as e:
            raise SystemExit(f"Error: {e}")
