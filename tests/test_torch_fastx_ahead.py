"""The read-ahead FASTX reader (io/fastx.py's ReadAhead) on the CPU.

Each file is inflated by `read_batches_native` on a worker thread of its
own; the consumer takes the files' batches round-robin in path order.
The tests hold that:

  * the rows are those of `read_batches_native` over the same files, as
    a multiset, for FASTA and FASTQ, with and without trimming, with
    partial last batches and with a file that holds no record;
  * the batch sequence is the round-robin interleave of the files' own
    batches, on every run, with a worker made to lag, with fewer turns
    than files and with queues of one batch;
  * a worker's error reaches the consumer with the file's path;
  * stopping early leaves no reader thread alive;
  * the reader's counts reach the `count` span, and each file's
    `inflate` span sits under it on a thread of its own;
  * without the native library the reader is the serial Python one.
"""

import gzip
import random
import re
import sys
import threading
import time

import numpy as np
import pytest

from ploidyfrost_tpu_torch import native
from ploidyfrost_tpu_torch.io import fastx
from ploidyfrost_tpu_torch.io.trim import TrimConfig
from ploidyfrost_tpu_torch.native import load_library
from ploidyfrost_tpu_torch.util import profiling
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)

K = 11
B = 16  # rows a batch: small, so that files span several batches
L = 48  # window width: long reads tile into several rows
JOIN_S = 30


@pytest.fixture
def native_reader():
    """The native FASTX reader, built on first use; decided in the test."""
    if load_library() is None:
        pytest.skip("the port's native FASTX reader did not build")


def _seqs(rng, n):
    """n reads of 0-130 bases with some Ns: short ones give no window,
    long ones tile into several."""
    return ["".join(rng.choice("ACGTACGTN") for _ in range(rng.randint(0, 130)))
            for _ in range(n)]


def _write(path, seqs, fmt, gz=True):
    op = gzip.open if gz else open
    with op(path, "wt") as f:
        for i, s in enumerate(seqs):
            if fmt == "fasta":
                f.write(f">r{i}\n{s}\n")
            else:
                qual = "".join(random.Random(i).choice("#+5?I") for _ in s)
                f.write(f"@r{i}\n{s}\n+\n{qual}\n")


def _files(tmp_path, n, fmt, empty=False, seed=0):
    """n files of different lengths; with `empty`, the second holds no
    record."""
    rng = random.Random(seed)
    paths = []
    for j in range(n):
        p = str(tmp_path / f"s{seed}f{j}.{'fa' if fmt == 'fasta' else 'fq'}.gz")
        _write(p, [] if empty and j == 1 else _seqs(rng, 40 + 23 * j), fmt)
        paths.append(p)
    return paths


def _rows(batches) -> list[bytes]:
    """The rows that hold a base, sorted: the batches' row multiset."""
    return sorted(r.tobytes() for b in batches for r in b if (r != fastx.INVALID_BASE).any())


def _interleave(per_file):
    """Round-robin over the files' batch lists, a file dropping out at
    its end."""
    out, j = [], 0
    while any(j < len(b) for b in per_file):
        out += [b[j] for b in per_file if j < len(b)]
        j += 1
    return out


def _expected(paths, trim=None):
    return _interleave([[b.copy() for b in fastx.read_batches_native([p], K, B, L, trim)]
                        for p in paths])


def _ahead(paths, trim=None):
    with fastx.ReadAhead([paths], K, B, L, trim) as r:
        return [b.copy() for b in r.sample(0)], r.counts[0]


def _reader_threads():
    return [t for t in threading.enumerate() if t.name.startswith("fastx-ahead")]


def _same_sequence(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fmt,trim", [
    ("fasta", None), ("fastq", None),
    ("fastq", TrimConfig(leading=3, trailing=3, window=4, window_quality=15, minlen=20)),
], ids=["fasta", "fastq", "fastq-trim"])
@pytest.mark.parametrize("n,empty", [(1, False), (2, False), (3, False), (3, True)],
                         ids=["1file", "2files", "3files", "3files-one-empty"])
def test_rows_equal_the_native_reader(native_reader, tmp_path, n, empty, fmt, trim):
    paths = _files(tmp_path, n, fmt, empty)
    got, counts = _ahead(paths, trim)
    want = list(fastx.read_batches_native(paths, K, B, L, trim))
    assert _rows(got) == _rows(want) and len(_rows(got)) > 0
    # each file ends in a partial batch of its own
    per_file = [sum(1 for _ in fastx.read_batches_native([p], K, B, L, trim)) for p in paths]
    assert len(got) == sum(per_file) == counts["batches"]
    assert all(b.shape == (B, L) for b in got)
    assert 1 <= counts["read_files"] <= n and 0 <= counts["batches_ready"] <= counts["batches"]
    assert _reader_threads() == []


def test_order_is_the_round_robin_of_the_files(native_reader, tmp_path, monkeypatch):
    """The same sequence on every run, whichever worker lags: file 0's
    first batch, file 1's first, file 2's first, file 0's second, ..."""
    paths = _files(tmp_path, 3, "fastq")
    want = _expected(paths)
    assert len(want) > 6
    real = fastx.read_batches_native
    for run in range(4):
        slow = run % 3

        def lagging(ps, *args, _slow=paths[slow], _rng=random.Random(run)):
            for b in real(ps, *args):
                if ps == [_slow]:
                    time.sleep(_rng.random() * 0.01)
                yield b

        monkeypatch.setattr(fastx, "read_batches_native", lagging)
        got, _ = _ahead(paths)
        _same_sequence(got, want)


def test_order_with_one_turn_and_queues_of_one(native_reader, tmp_path, monkeypatch):
    """More files than turns and queues of one batch, with the
    interpreter switching threads often: the sequence is the same, no
    file waits for ever on another's full queue, and at most one file
    inflates at once."""
    samples = [_files(tmp_path, 2 + s % 2, "fasta", seed=s) for s in range(3)]
    want = [_expected(files) for files in samples]
    monkeypatch.setattr(fastx, "AHEAD_BATCHES", 1)
    monkeypatch.setattr(fastx.os, "sched_getaffinity", lambda pid: {0})
    got = []

    def consume():  # on a thread of its own, so that a reader stuck for ever fails the test
        for _ in range(3):
            with fastx.ReadAhead(samples, K, B, L) as r:
                got.append(([[b.copy() for b in r.sample(i)] for i in range(len(samples))],
                            [c["read_files"] for c in r.counts]))

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=consume, daemon=True)
        t.start()
        t.join(JOIN_S)
    finally:
        sys.setswitchinterval(before)
    assert not t.is_alive() and len(got) == 3
    for batches, read_files in got:
        for i in range(len(samples)):
            _same_sequence(batches[i], want[i])
        assert read_files == [1, 1, 1]
    assert _reader_threads() == []


def test_samples_in_turn_from_one_reader(native_reader, tmp_path):
    """Several samples from one reader: each sample's own sequence, its
    window width from its own first record."""
    short = str(tmp_path / "short.fa.gz")
    _write(short, ["ACGT" * 10] * 30, "fasta")
    a = _files(tmp_path, 2, "fastq")
    with fastx.ReadAhead([a, [short]], K, B) as r:
        assert r.max_lens == [fastx._auto_max_len(a, K), fastx._auto_max_len([short], K)]
        got = [[b.copy() for b in r.sample(i)] for i in range(2)]
    _same_sequence(got[0], _interleave([[b.copy() for b in fastx.read_batches_native(
        [p], K, B, r.max_lens[0])] for p in a]))
    _same_sequence(got[1], [b.copy() for b in fastx.read_batches_native(
        [short], K, B, r.max_lens[1])])


def test_truncated_gz_in_the_second_file_names_it(native_reader, tmp_path):
    paths = _files(tmp_path, 2, "fastq")
    with open(paths[1], "rb") as f:
        whole = f.read()
    with open(paths[1], "wb") as f:
        f.write(whole[: len(whole) // 2])
    with pytest.raises(IOError, match=re.escape(paths[1])):
        _ahead(paths)
    assert _reader_threads() == []


def test_missing_file_raises_file_not_found(native_reader, tmp_path):
    paths = _files(tmp_path, 1, "fasta") + [str(tmp_path / "missing.fa")]
    with pytest.raises(FileNotFoundError, match="missing.fa"):
        _ahead(paths)
    assert _reader_threads() == []


@pytest.mark.parametrize("how", ["close", "raise"])
def test_early_stop_leaves_no_thread(native_reader, tmp_path, monkeypatch, how):
    """The generator closed after one batch, or the consumer raising
    inside the reader's `with`, with workers blocked on full queues:
    every reader thread ends."""
    monkeypatch.setattr(fastx, "AHEAD_BATCHES", 2)
    paths = _files(tmp_path, 3, "fastq")
    if how == "close":
        r = fastx.ReadAhead([paths], K, B, L)
        batches = r.sample(0)
        next(batches)
        time.sleep(0.05)  # the workers fill their queues
        batches.close()
    else:
        with pytest.raises(ValueError):
            with fastx.ReadAhead([paths], K, B, L) as r:
                for _ in r.sample(0):
                    time.sleep(0.05)
                    raise ValueError("the consumer failed")
    deadline = time.time() + JOIN_S
    while _reader_threads() and time.time() < deadline:
        time.sleep(0.01)
    assert _reader_threads() == []


def test_counts_and_inflate_spans_under_count(native_reader, tmp_path, monkeypatch):
    """count_sample puts the reader's counts on the open `count` span; one
    `inflate` span a file sits under it, each on a thread of its own. The
    files are small, so each batch is slowed for the two to inflate at
    once."""
    from ploidyfrost_tpu_torch import resolve_device
    from ploidyfrost_tpu_torch.pipeline import count_sample

    real = fastx.read_batches_native

    def slow(*args):
        for b in real(*args):
            time.sleep(0.01)
            yield b

    monkeypatch.setattr(fastx, "read_batches_native", slow)
    paths = _files(tmp_path, 2, "fastq")
    rec = profiling.Spans()
    with rec.command("pipeline", "x", primary=False):
        with profiling.span("count") as count:
            with fastx.ReadAhead([paths], K, B, L) as r:
                counter = count_sample(r, 0, resolve_device("cpu"))
    assert counter.total_kmers > 0
    attrs = count.attrs
    assert attrs["read_files"] == 2
    assert attrs["batches"] == len(_expected(paths)) == r.counts[0]["batches"]
    assert 0 <= attrs["batches_ready"] <= attrs["batches"]
    inflate = [s for s in rec.spans if s.name == "inflate"]
    assert len(inflate) == 2 and all(s.parent is count for s in inflate)
    assert len({s.thread for s in inflate} | {count.thread}) == 3
    assert all(count.start_ns <= s.start_ns <= s.end_ns <= count.end_ns for s in inflate)
    assert rec.stage_seconds()["inflate"] > 0


def test_without_the_native_library_the_reader_is_serial(tmp_path, monkeypatch):
    """PLOIDYFROST_NO_NATIVE or a failed build: no thread, and the batches
    of read_batches_py over the sample's files, byte for byte."""
    monkeypatch.setattr(native, "load_library", lambda: None)
    paths = _files(tmp_path, 2, "fasta")
    with fastx.ReadAhead([paths], K, B, L) as r:
        assert _reader_threads() == []
        got = [b.copy() for b in r.sample(0)]
    _same_sequence(got, [b.copy() for b in fastx.read_batches_py(paths, K, B, L)])
    assert r.counts[0] == {"read_files": 1, "batches": len(got), "batches_ready": 0}
