# Copied from ploidyfrost_tpu/io/fastx.py; imports point at this package.
"""FASTA/FASTQ (optionally gzipped) readers producing fixed-shape batches.

Replaces the role of bifrost/src/{FASTX_Parser,File_Parser,kseq.h}: the
host side streams sequences and packs them into padded [B, L] uint8 code
arrays (0..3 = ACGT, 4 = N/padding) that feed the device k-mer pipeline
with static shapes. Reads longer than the batch width are split into
overlapping segments (k-1 overlap) so no k-mer is lost at a seam.

Two implementations with identical semantics:

  * ``read_batches_py`` — pure Python (always available; the test oracle);
  * the native C++ loader (native/fastx_reader.cpp, ctypes-bound via
    native/__init__.py) — used transparently by ``ReadAhead`` and
    ``read_batches`` when it builds/loads, because gzip + per-line Python
    loops are the ingest bottleneck once counting itself runs at device
    speed; ``ReadAhead`` runs it on worker threads, one a file, ahead of
    the counter.

``tests/test_native.py`` asserts byte-identical batches between the two.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import os
import threading
from typing import Iterator

import numpy as np

from ..kmer.pack import INVALID_BASE, encode_bases
from ..util import profiling

# batches a file's queue holds at most: 64 MiB at 150 bp reads, whose
# [16384, 160] batches are 2.6 MB
AHEAD_BATCHES = 24


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def iter_sequences(path: str) -> Iterator[bytes]:
    """Yield raw sequence bytes from a FASTA or FASTQ file (gz ok)."""
    with _open(path) as f:
        first = f.peek(1)[:1] if hasattr(f, "peek") else b""
        if not first:
            line = f.readline()
            if not line:
                return
            first = line[:1]
            rest = _iter_from(f, line)
            yield from rest
            return
        if first == b">":
            # FASTA: concatenate wrapped lines per record
            seq_parts: list[bytes] = []
            for line in f:
                line = line.rstrip()
                if line.startswith(b">"):
                    if seq_parts:
                        yield b"".join(seq_parts)
                        seq_parts = []
                else:
                    seq_parts.append(line)
            if seq_parts:
                yield b"".join(seq_parts)
        elif first == b"@":
            for seq, _ in _iter_fastq(f):
                yield seq
        else:
            raise ValueError(f"unrecognized FASTX format in {path}")


def _iter_fastq(f) -> Iterator[tuple[bytes, bytes]]:
    """kseq-style FASTQ records: sequence lines accumulate until the
    '+' separator, quality lines until they cover the sequence length —
    multi-line FASTQ parses correctly, not just 4-line records
    (bifrost/src/kseq.h semantics)."""
    while True:
        hdr = f.readline()
        if not hdr:
            return
        if not hdr.startswith((b"@", b">")):
            # junk-line skip, LINE-level approximation of kseq's
            # char-level scan (bifrost/src/kseq.h): blank separator
            # lines (e.g. the unconsumed empty quality of a zero-length
            # read) and junk lines are skipped, not treated as headers.
            # kseq would instead start a record at an '@'/'>' appearing
            # MID-line; on well-formed FASTQ the two are identical, and
            # the Python and native readers agree with each other
            # (parity-tested) on malformed input
            continue
        seq_parts: list[bytes] = []
        line = f.readline()
        while line and not line.startswith(b"+"):
            seq_parts.append(line.rstrip())
            line = f.readline()
        seq = b"".join(seq_parts)
        qual_parts: list[bytes] = []
        qlen = 0
        while qlen < len(seq):
            line = f.readline()
            if not line:
                break
            part = line.rstrip()
            qual_parts.append(part)
            qlen += len(part)
        if seq:
            yield seq, b"".join(qual_parts)


def iter_sequences_with_qual(path: str) -> Iterator[tuple[bytes, bytes | None]]:
    """Yield (sequence, quality-or-None) — the quality line feeds the
    optional trimming stage (Trimmomatic's role, script/pipeline/1.trim)."""
    with _open(path) as f:
        first = f.peek(1)[:1] if hasattr(f, "peek") else b""
        if first == b"@":
            yield from _iter_fastq(f)
            return
    for seq in iter_sequences(path):
        yield seq, None


def _iter_from(f, firstline: bytes) -> Iterator[bytes]:
    if firstline.startswith(b">"):
        seq_parts: list[bytes] = []
        for line in f:
            line = line.rstrip()
            if line.startswith(b">"):
                if seq_parts:
                    yield b"".join(seq_parts)
                    seq_parts = []
            else:
                seq_parts.append(line)
        if seq_parts:
            yield b"".join(seq_parts)
    else:
        raise ValueError("unsupported stream")


def read_batches_py(
    paths: list[str] | str,
    k: int,
    batch_reads: int = 4096,
    max_len: int = 512,
    trim=None,
) -> Iterator[np.ndarray]:
    """Pure-Python batcher: yield [batch_reads, max_len] uint8 code
    batches from FASTX files.

    Sequences longer than max_len are tiled into windows overlapping by
    k-1 bases. Padding uses INVALID_BASE so padded windows produce no
    valid k-mers.

    ``trim`` (a ``trim.TrimConfig``) enables the quality-trimming stage
    (Trimmomatic's role in the reference pipeline, script/pipeline/1.trim)
    on FASTQ inputs before batching.
    """
    if isinstance(paths, str):
        paths = [paths]
    buf = np.full((batch_reads, max_len), INVALID_BASE, dtype=np.uint8)
    row = 0

    def _sequences(path):
        if trim is None:
            yield from iter_sequences(path)
        else:
            from .trim import trim_read

            for seq, qual in iter_sequences_with_qual(path):
                t = trim_read(seq, qual, trim)
                if t:
                    yield t

    for path in paths:
        for seq in _sequences(path):
            codes = encode_bases(seq)
            n = len(codes)
            step = max_len - (k - 1)
            for start in range(0, max(n - k + 1, 1), step):
                chunk = codes[start : start + max_len]
                if len(chunk) < k:
                    break
                buf[row, : len(chunk)] = chunk
                row += 1
                if row == batch_reads:
                    yield buf
                    buf = np.full((batch_reads, max_len), INVALID_BASE, dtype=np.uint8)
                    row = 0
    if row:
        yield buf


def read_batches_native(
    paths: list[str] | str,
    k: int,
    batch_reads: int = 4096,
    max_len: int = 512,
    trim=None,
) -> Iterator[np.ndarray]:
    """Native C++ batcher (fastx_reader.cpp), with the optional
    quality-trimming cascade applied in C (pfx_set_trim). Raises
    RuntimeError if the library is unavailable — use read_batches for
    automatic fallback."""
    import ctypes

    from ..native import load_library

    lib = load_library()
    if lib is None:
        raise RuntimeError("native fastx reader unavailable")
    if isinstance(paths, str):
        paths = [paths]
    row = 0
    buf = np.empty((batch_reads, max_len), dtype=np.uint8)
    u8p = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    eof = ctypes.c_int(0)
    for path in paths:
        h = lib.pfx_open(path.encode())
        if not h:
            raise FileNotFoundError(path)
        if trim is not None:
            lib.pfx_set_trim(
                h, trim.leading, trim.trailing, trim.window,
                trim.window_quality, trim.minlen,
            )
        try:
            while True:
                rows = lib.pfx_next_batch(
                    h, u8p, batch_reads, max_len, k, row, ctypes.byref(eof)
                )
                if rows < 0:
                    raise IOError(
                        f"{path}: {lib.pfx_error(h).decode(errors='replace')}"
                    )
                row = int(rows)
                if row == batch_reads:
                    yield buf
                    buf = np.empty((batch_reads, max_len), dtype=np.uint8)
                    u8p = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
                    row = 0
                if eof.value:
                    break
        finally:
            lib.pfx_close(h)
    if row:
        yield buf


def _auto_max_len(paths: list[str], k: int, cap: int = 512) -> int:
    """Window width sized from the first record: a 150 bp read in a
    512-wide row is ~70% padding, and padding costs real transfer bytes
    and sort slots downstream. Short-read files get a snug width
    (rounded up to 32); anything at or beyond the cap keeps the cap
    (longer sequences tile into overlapping windows either way, k-mer
    multiset unchanged)."""
    try:
        first = next(iter_sequences(paths[0]), None)
    except (OSError, ValueError):
        return cap
    if first is None:
        return cap
    n = len(first)
    if n >= cap:
        return cap
    return max(64, k + 7, (n + 31) & ~31)


def read_batches(
    paths: list[str] | str,
    k: int,
    batch_reads: int = 16384,
    max_len: int | None = None,
    trim=None,
) -> Iterator[np.ndarray]:
    """Yield [batch_reads, max_len] uint8 code batches of one sample's
    FASTX files through ReadAhead: each file read ahead on a thread of
    its own when the native loader is available, its batches taken
    round-robin; else read_batches_py over the files (identical rows,
    including the quality-trimming cascade, which the native reader
    applies in C — tests/test_trim.py asserts batch parity).
    ``max_len=None`` sizes the window from the first record
    (_auto_max_len)."""
    if isinstance(paths, str):
        paths = [paths]
    with ReadAhead([paths], k, batch_reads, max_len, trim) as reader:
        yield from reader.sample(0)


class ReadAhead:
    """Every sample's FASTX files read ahead of the counter: each file
    inflated and parsed by `read_batches_native` on a worker thread of
    its own, into a queue of its own of at most AHEAD_BATCHES batches.

    `sample(i)` yields sample i's batches round-robin over its files in
    path order (file 0's first batch, file 1's first, file 0's second,
    ...; a file that ends drops out), so the sequence depends on the
    inputs alone: the ranks of a group, which each read every batch,
    agree batch for batch. Each file ends in a partial batch of its own,
    padded with the invalid code. Later samples' files inflate while the
    current one is counted, until their queues are full.

    At most max(1, min(files, usable cores - 1)) files inflate at once; a
    worker whose queue is full gives its turn up, and the turns go to the
    first files in path order. A worker's exception (a missing file, a
    truncated gz) is raised by `sample` where that file's next batch would
    have come. Leaving the `with` block, `close()`, or a sample's batches
    left before their end (an error, or the generator closed) stops every
    worker, closes its file and joins its thread.

    Without the native library, whose calls release the GIL, `sample(i)`
    is the serial `read_batches_py` over sample i's files.

    `counts[i]`, once sample i's batches have been taken: `read_files`
    (the files inflating at once, at most, since the reader began or the
    batches of the sample before were taken), `batches` (yielded) and
    `batches_ready` (already queued when asked for). Each worker runs in
    an `inflate` span, a child of the span open where the reader was
    made."""

    def __init__(self, samples, k: int, batch_reads: int = 16384, max_len: int | None = None,
                 trim=None):
        from ..native import load_library

        self.samples = [list(s) for s in samples]
        self.k, self.batch_reads, self.trim = k, batch_reads, trim
        self.max_lens = [max_len or _auto_max_len(s, k) for s in self.samples]
        self.counts: list[dict] = [{} for _ in self.samples]
        self._files = [(i, p) for i, s in enumerate(self.samples) for p in s]
        n = len(self._files)
        self._cond = threading.Condition()
        self._queues = [collections.deque() for _ in range(n)]
        self._done = [False] * n
        self._errors: list[Exception | None] = [None] * n
        self._turns = self._free = max(1, min(n, len(os.sched_getaffinity(0)) - 1))
        self._waiting: list[int] = []  # files waiting for a turn
        self._peak = 0
        self._stop = False
        self._parent = profiling.current()
        self._threads = []
        if load_library() is not None:
            self._threads = [threading.Thread(target=self._work, args=(f,), daemon=True,
                                              name=f"fastx-ahead-{f}") for f in range(n)]
        for t in self._threads:
            t.start()

    def __enter__(self) -> ReadAhead:
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for t in self._threads:
            t.join()

    def _take_turn(self, f: int) -> bool:
        """Wait (holding the lock) for a turn to inflate, given first to
        the first file in path order; False once the reader stops."""
        self._waiting.append(f)
        while not self._stop and not (self._free and min(self._waiting) == f):
            self._cond.wait()
        self._waiting.remove(f)
        self._cond.notify_all()  # the next file in line may take a turn left free
        if self._stop:
            return False
        self._free -= 1
        self._peak = max(self._peak, self._turns - self._free)
        return True

    def _give_turn(self) -> None:
        self._free += 1
        self._cond.notify_all()

    def _work(self, f: int) -> None:
        i, path = self._files[f]
        batches = read_batches_native([path], self.k, self.batch_reads, self.max_lens[i],
                                      self.trim)
        q = self._queues[f]
        held = False
        try:
            with self._cond:
                held = self._take_turn(f)
            if not held:
                return
            p = self._parent
            with contextlib.nullcontext() if p is None else p.record.span("inflate", p):
                for buf in batches:  # the native calls release the GIL
                    with self._cond:
                        if len(q) >= AHEAD_BATCHES:
                            self._give_turn()
                            held = False
                            while len(q) >= AHEAD_BATCHES and not self._stop:
                                self._cond.wait()
                            held = self._take_turn(f)
                        if self._stop:
                            return
                        q.append(buf)
                        self._cond.notify_all()
        except Exception as e:  # raised again by sample(), where this file's batch was due
            self._errors[f] = e
        finally:
            batches.close()
            with self._cond:
                if held:
                    self._give_turn()
                self._done[f] = True
                self._cond.notify_all()

    def sample(self, i: int) -> Iterator[np.ndarray]:
        """Sample i's batches, in the order the class docstring gives."""
        if not self._threads:
            return self._serial(i)
        return self._round_robin(i)

    def _round_robin(self, i: int) -> Iterator[np.ndarray]:
        files = [f for f, (s, _) in enumerate(self._files) if s == i]
        n = ready = 0
        try:
            while files:
                for f in list(files):
                    q = self._queues[f]
                    with self._cond:
                        ready += bool(q)
                        while not q and not self._done[f]:
                            self._cond.wait()
                        if not q:
                            if self._errors[f] is not None:
                                raise self._errors[f]
                            files.remove(f)
                            continue
                        buf = q.popleft()
                        self._cond.notify_all()
                    n += 1
                    yield buf
        finally:
            with self._cond:
                self.counts[i] = {"read_files": self._peak, "batches": n, "batches_ready": ready}
                self._peak = self._turns - self._free
            if files:  # stopped early, by the consumer or by a worker's error
                self.close()

    def _serial(self, i: int) -> Iterator[np.ndarray]:
        n = 0
        try:
            for buf in read_batches_py(self.samples[i], self.k, self.batch_reads,
                                       self.max_lens[i], trim=self.trim):
                n += 1
                yield buf
        finally:
            self.counts[i] = {"read_files": 1, "batches": n, "batches_ready": 0}
