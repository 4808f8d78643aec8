"""Plain reference of the count table: canonical k-mers of the reads,
counted, clamped at the counter's cap, and their histogram.

Plain torch on the given device. Keys are 2-bit packed, the first base
in the highest bits (A 0, C 1, G 2, T 3); the canonical key is the
smaller of a window and its reverse complement. The reads come from the
benchmark's own generator (benchmark/gen/reads.py): the bytes the
program reads from disk, made again from the seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gen import reads


def window_keys(codes: torch.Tensor, k: int) -> torch.Tensor:
    """[n, L] codes 0..3 -> [n, L - k + 1] canonical int64 keys."""
    x = codes.to(torch.int64)
    w = x.shape[1] - k + 1
    fwd = torch.zeros((x.shape[0], w), dtype=torch.int64, device=x.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << 2) | x[:, j:j + w]
        rev = rev | ((3 - x[:, j:j + w]) << (2 * j))
    return torch.minimum(fwd, rev)


def revcomp(keys: torch.Tensor, k: int) -> torch.Tensor:
    out = torch.zeros_like(keys)
    x = keys
    for _ in range(k):
        out = (out << 2) | (3 - (x & 3))
        x = x >> 2
    return out


def canonical(keys: torch.Tensor, k: int) -> torch.Tensor:
    return torch.minimum(keys, revcomp(keys, k))


def count_sample(cfg: dict, seed: int, sample: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(sorted unique keys, counts clamped at counter_max) of one sample."""
    k = cfg["k"]
    parts = []
    for mate in (1, 2):
        for block in reads.mate_codes(cfg, seed, sample, mate):
            parts.append(window_keys(torch.from_numpy(block).to(device), k).reshape(-1))
    keys = torch.cat(parts)
    del parts
    keys = torch.sort(keys).values
    uniq, cnt = torch.unique_consecutive(keys, return_counts=True)
    del keys
    return uniq, cnt.clamp_(max=cfg["counter_max"])


def histogram(counts: torch.Tensor, cap: int) -> np.ndarray:
    """hist[c] = distinct keys with count c, c = 0..cap (hist[0] = 0)."""
    h = torch.bincount(counts, minlength=cap + 1)[: cap + 1].cpu().numpy().astype(np.int64)
    h[0] = 0
    return h


def cutoff_lower(hist: np.ndarray) -> int:
    """The first valley: the first count c (from 1) whose successor bin
    holds more k-mers, as round(1.25 * (c - 1)); at least 10
    (the upstream's cutoffL and its callers' floor)."""
    h = hist[1:]
    rise = np.flatnonzero(h[:-1] < h[1:])
    peak = int(rise[0]) + 1 if len(rise) else len(h)
    x = 1.25 * (peak - 1)
    return max(10, int(np.floor(x + 0.5)))


def cutoff_upper(hist: np.ndarray, quantile: float = 0.998) -> int:
    """The count at which the cumulative number of distinct k-mers,
    the first bin taken as the base, first passes `quantile` of the
    rest (the upstream's cutoffH)."""
    cum = np.concatenate([[0], np.cumsum(hist[1:])])
    cf = quantile * (cum[-1] - cum[1]) + cum[1]
    over = np.flatnonzero(cum[2:] > cf)
    return int(over[0]) + 2 if len(over) else len(cum)
