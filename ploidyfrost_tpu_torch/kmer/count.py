"""Device-resident k-mer counting (counterpart of ploidyfrost_tpu/kmer/count.py).

The reference pipeline shells out to `kmc -ci1 -cs10000 -k25`
(script/pipeline/2.kmc_db:12). Here, as in the JAX package:

    read batch -> K1 (canonical keys, kmer/extract.py) -> instance buffer
               -> (rare) collapse: sort + run-length count + merge

  * add_reads copies a [B, L] code batch to the device and K1 writes its
    int64 canonical keys straight into the instance buffer at `fill`,
    and in the same launch adds the batch's number of valid windows into
    the device counter `_n_valid_dev`: one kernel a batch, no separate
    reduction, no host sync per batch.
  * flush sorts the filled part of the buffer, run-length counts it
    (unique_consecutive), and merges the runs into the resident table of
    unique keys with a second sort. Counts are clamped to counter_max at
    every merge, which reproduces KMC's -cs saturation exactly:
    clamp(a)+clamp(b) re-clamped == clamp(a+b) whenever either side or
    the sum crosses the cap.
  * torch shapes are dynamic, so a collapse returns every unique key and
    the table takes the true unique count at once. The JAX counter's
    fixed-capacity table detects overflow from the same true count and
    grows and replays the buffer; here nothing is truncated, so there is
    nothing to replay.

Keys are int64 with the INT64_MAX sentinel (kmer/pack.SENTINEL) on
invalid windows; `arrays()` hands out numpy uint64 keys as the JAX
counter does. Histograms are one bincount at finalize.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..util.profiling import add_count
from .extract import extract_canonical_into
from .pack import SENTINEL

# KMC counter saturation: -cs10000 (script/pipeline/2.kmc_db:12).
DEFAULT_COUNTER_MAX = 10000


def _collapse(tkm, tct, keys, counter_max: int):
    """Merge the instance keys `keys` (any order, sentinels allowed)
    into the sorted unique table (tkm, tct). Returns the new table."""
    bkm, bcnt = torch.unique_consecutive(torch.sort(keys).values, return_counts=True)
    if bkm.numel() and int(bkm[-1]) == SENTINEL:
        # the sentinel run (invalid windows) sorts last: drop it
        bkm, bcnt = bkm[:-1], bcnt[:-1]
    mkm, order = torch.sort(torch.cat([tkm, bkm]))
    mct = torch.cat([tct, bcnt])[order]
    ukm, inv = torch.unique_consecutive(mkm, return_inverse=True)
    uct = torch.zeros(ukm.numel(), dtype=torch.int64, device=ukm.device)
    uct.index_add_(0, inv, mct)
    return ukm, uct.clamp_(max=counter_max)


class KmerCounter:
    """Streaming canonical k-mer counter with a device-resident table."""

    def __init__(
        self,
        k: int,
        counter_max: int = DEFAULT_COUNTER_MAX,
        buffer_capacity: int | None = None,
        device: str | torch.device = "cuda",
    ):
        if not 1 <= k <= 31:
            raise ValueError("k must be in [1, 31] for single-word packing")
        self.device = resolve_device(device)
        if buffer_capacity is None:
            # 32M instances (256 MB) on the card: a 5 Mbp genome at 25x
            # (~105M instances) collapses 4 times; the host keeps 8M
            buffer_capacity = (32 << 20) if self.device.type == "cuda" else (8 << 20)
        self.k = k
        self.counter_max = counter_max
        self._tkm = torch.empty(0, dtype=torch.int64, device=self.device)
        self._tct = torch.empty(0, dtype=torch.int64, device=self.device)
        self._buf = torch.empty(buffer_capacity, dtype=torch.int64, device=self.device)
        self._fill = 0
        self._n_valid_dev = torch.zeros((), dtype=torch.int64, device=self.device)
        self._total_host = 0

    # -- properties ------------------------------------------------------

    @property
    def total_kmers(self) -> int:
        """Total (valid) k-mer instances processed. Syncs the device."""
        return self._total_host + int(self._n_valid_dev)

    @property
    def num_unique(self) -> int:
        self.flush()
        return int(self._tkm.numel())

    # -- ingestion -------------------------------------------------------

    def add_reads(self, codes):
        """Count all canonical k-mers of a [B, L] uint8 code batch
        (numpy array or tensor)."""
        codes = torch.as_tensor(codes)
        B, L = codes.shape
        n_row = L - self.k + 1
        if n_row <= 0:
            return
        cap = self._buf.numel()
        if B * n_row > cap:
            # a batch larger than the whole buffer: feed it in row blocks
            step = max(cap // n_row, 1)
            for r in range(0, B, step):
                self.add_reads(codes[r : r + step])
            return
        if self._fill + B * n_row > cap:
            self.flush()
        add_count("h2d_bytes", codes.nbytes)
        dev = codes.to(self.device).contiguous()
        extract_canonical_into(dev, self.k, self._buf, self._fill, count=self._n_valid_dev)
        self._fill += B * n_row

    def add_kmers(self, canon, valid=None):
        """Count canonical keys given as they are (uint64 numpy array or
        int64 tensor, any shape), each below 2^62; `valid` (bool, same
        size) marks the ones to count, the others become the sentinel.
        The valid count adds to total_kmers."""
        if isinstance(canon, torch.Tensor):
            keys = canon.reshape(-1).to(self.device, torch.int64)
        else:
            keys = torch.from_numpy(
                np.ascontiguousarray(canon, dtype=np.uint64).reshape(-1).view(np.int64)
            ).to(self.device)
        if keys.numel() and bool(((keys < 0) | (keys >= 1 << 62)).any()):
            raise ValueError("canonical keys must lie in [0, 2^62)")
        if valid is None:
            self._n_valid_dev += keys.numel()
        else:
            valid = torch.as_tensor(valid).reshape(-1).to(self.device, torch.bool)
            keys = torch.where(valid, keys, SENTINEL)
            self._n_valid_dev += valid.sum()
        cap = self._buf.numel()
        for off in range(0, keys.numel(), cap):  # chunks of the buffer's size
            part = keys[off : off + cap]
            if self._fill + part.numel() > cap:
                self.flush()
            self._buf[self._fill : self._fill + part.numel()] = part
            self._fill += part.numel()

    # -- collapse --------------------------------------------------------

    def flush(self):
        """Collapse the instance buffer into the unique table."""
        if self._fill == 0:
            return
        self._tkm, self._tct = _collapse(
            self._tkm, self._tct, self._buf[: self._fill], self.counter_max
        )
        self._fill = 0
        self._total_host += int(self._n_valid_dev)
        self._n_valid_dev.zero_()

    # -- finalization / views ---------------------------------------------

    def arrays(self):
        """(sorted unique canonical k-mers uint64, saturated counts
        int64) as host numpy arrays (counts are clamped at every merge)."""
        self.flush()
        km = self._tkm.cpu().numpy().view(np.uint64)
        ct = self._tct.cpu().numpy()
        add_count("d2h_bytes", km.nbytes + ct.nbytes)
        return km, ct

    def histogram(self, max_cov: int | None = None) -> np.ndarray:
        """KMC-style histogram: hist[c] = number of distinct k-mers with
        (saturated) count c, for c in 1..max_cov. Index 0 unused.

        Matches `kmc_tools transform db histogram` consumed by cutoffL/H
        (script/pipeline/2.kmc_db:14, src/Main.cpp:200-277).
        """
        self.flush()
        if max_cov is None:
            max_cov = self.counter_max
        hist = torch.bincount(self._tct.clamp(0, max_cov), minlength=max_cov + 1)[: max_cov + 1]
        hist[0] = 0
        return hist.cpu().numpy().astype(np.int64)

    def write_histogram(self, path: str, max_cov: int = 10000):
        """Text histogram file: "<cov>\\t<count>" per line, cov = 1..max_cov."""
        hist = self.histogram(max_cov)
        with open(path, "w") as f:
            for cov in range(1, max_cov + 1):
                f.write(f"{cov}\t{int(hist[cov]) if cov < len(hist) else 0}\n")


def counter_from_arrays(kmers, counts, k: int, device="cuda", **kw) -> KmerCounter:
    """A counter whose table holds (kmers, counts): sorted unique uint64
    keys and their counts as host arrays, e.g. the JAX counter's
    `arrays()` output. Counts are clamped to the counter's counter_max."""
    c = KmerCounter(k, device=device, **kw)
    km = np.ascontiguousarray(kmers, dtype=np.uint64).view(np.int64)
    ct = np.asarray(counts, dtype=np.int64)
    if km.shape != ct.shape or km.ndim != 1:
        raise ValueError("kmers and counts must be 1-d arrays of one length")
    if len(km) and not (np.diff(km) > 0).all():
        raise ValueError("kmers must be sorted and unique")
    c._tkm = torch.from_numpy(km.copy()).to(c.device)
    c._tct = torch.from_numpy(ct.copy()).clamp_(max=c.counter_max).to(c.device)
    return c
