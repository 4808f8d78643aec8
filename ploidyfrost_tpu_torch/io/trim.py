# Copied from ploidyfrost_tpu/io/trim.py; imports point at this package.
"""Quality trimming of FASTQ reads — the Trimmomatic stage's role.

The reference pipeline trims paired reads with Trimmomatic before
counting (the reference's script/pipeline/1.trim:16):

    LEADING:10 TRAILING:10 SLIDINGWINDOW:3:20 MINLEN:50   (phred33)

This module reimplements those four operators on (sequence, quality)
byte strings so the native pipeline covers the whole reference stack
without an external Java dependency. Semantics follow Trimmomatic's
documented behavior; steps apply in the order given on the reference
command line (LEADING, TRAILING, SLIDINGWINDOW, MINLEN):

  * LEADING:q    — drop bases from the 5' end while quality < q;
  * TRAILING:q   — drop bases from the 3' end while quality < q;
  * SLIDINGWINDOW:w:q — scan 5'→3'; at the first length-w window whose
    mean quality < q, cut the read there, first extending through any
    leading bases of that window that individually pass q (Trimmomatic
    keeps individually-good bases at the cut point);
  * MINLEN:n     — discard the read entirely if fewer than n bases remain.

Reads without a quality line (FASTA input) pass through untouched.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PHRED_OFFSET = 33  # phred33, as the reference invocation assumes


@dataclass(frozen=True)
class TrimConfig:
    """Defaults = the reference pipeline's Trimmomatic arguments
    (script/pipeline/1.trim:16)."""

    leading: int = 10
    trailing: int = 10
    window: int = 3
    window_quality: int = 20
    minlen: int = 50

    @classmethod
    def parse(cls, spec: str) -> "TrimConfig":
        """Parse a Trimmomatic-style spec, e.g.
        'LEADING:10,TRAILING:10,SLIDINGWINDOW:3:20,MINLEN:50'.
        An empty spec yields the defaults."""
        cfg = {}
        for step in filter(None, spec.split(",")):
            parts = step.split(":")
            name = parts[0].upper()
            try:
                if name == "LEADING":
                    cfg["leading"] = int(parts[1])
                elif name == "TRAILING":
                    cfg["trailing"] = int(parts[1])
                elif name == "SLIDINGWINDOW":
                    cfg["window"] = int(parts[1])
                    cfg["window_quality"] = int(parts[2])
                elif name == "MINLEN":
                    cfg["minlen"] = int(parts[1])
                else:
                    raise ValueError(f"unknown trim step: {step}")
            except (IndexError, ValueError) as e:
                if "unknown trim step" in str(e):
                    raise
                raise ValueError(
                    f"malformed trim step: {step!r} (expected e.g. "
                    f"LEADING:10 or SLIDINGWINDOW:3:20)"
                ) from None
        return cls(**cfg)


def trim_read(seq: bytes, qual: bytes | None, cfg: TrimConfig) -> bytes:
    """Apply the trimming cascade to one read; returns b'' if dropped.

    FASTA reads (qual is None) are passed through (no quality signal),
    matching the pipeline which only ever trims FASTQ.
    """
    if qual is None:
        return seq
    q = np.frombuffer(qual, dtype=np.uint8).astype(np.int32) - PHRED_OFFSET
    n = min(len(seq), len(q))
    lo, hi = 0, n  # current kept half-open interval

    if cfg.leading > 0:
        good = np.nonzero(q[lo:hi] >= cfg.leading)[0]
        lo = lo + int(good[0]) if len(good) else hi
    if cfg.trailing > 0 and hi > lo:
        good = np.nonzero(q[lo:hi] >= cfg.trailing)[0]
        hi = lo + int(good[-1]) + 1 if len(good) else lo

    w, wq = cfg.window, cfg.window_quality
    if w > 0:
        if hi - lo < w:
            # Trimmomatic's SlidingWindowTrimmer drops reads shorter
            # than the window outright (masked in the pipeline defaults
            # by MINLEN:50 >> window 3, but observable otherwise)
            hi = lo
        else:
            win = q[lo:hi].astype(np.float64)
            csum = np.concatenate(([0.0], np.cumsum(win)))
            means = (csum[w:] - csum[:-w]) / w  # mean per window start
            bad = np.nonzero(means < wq)[0]
            if len(bad):
                cut = int(bad[0])
                # extend through individually-good bases at the cut
                while cut < hi - lo and win[cut] >= wq:
                    cut += 1
                hi = lo + cut

    if hi - lo < cfg.minlen:
        return b""
    return seq[lo:hi]


def trim_batch(
    reads: list[tuple[bytes, bytes | None]], cfg: TrimConfig
) -> list[bytes]:
    """Trim a list of (seq, qual) pairs; dropped reads are omitted."""
    out = []
    for seq, qual in reads:
        t = trim_read(seq, qual, cfg)
        if t:
            out.append(t)
    return out
