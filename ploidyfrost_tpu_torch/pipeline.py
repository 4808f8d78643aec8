# Ported from ploidyfrost_tpu/pipeline.py.
"""End-to-end analysis entry points: the `run`, `build`, `pipeline` and
`pipeline-multi` subcommands.

`run_analysis` replaces the reference main path (src/Main.cpp:817-853):
load graph -> setUnitigId -> printInfo -> findSuperBubble ->
ploidyEstimation; `run_colored_analysis` is its multi-sample (colored)
counterpart (src/Main.cpp:777-813). `run_pipeline_cli` runs the whole
single-sample pipeline (the reference's script/pipeline/run.sh): reads
-> count -> cutoffs -> graph -> `run_analysis` -> model;
`run_multisample_pipeline_cli` does the same for several samples
(script/pipeline/run-multisample.sh) over one colored graph.

All take `device` ("cuda" by default; raises when CUDA is absent, see
resolve_device). On it run the k-mer extraction kernel, the counter's
sort-collapse and histogram, the superbubble search and the GMM-EM fit;
graph construction, coverage probes, alignment and table output are
host code (the alignment DP moves to the device only where the native
NW kernel is missing, align/batch_nw.py). `pipeline`, `pipeline-multi`
and `run` record their stages as spans in `opt.spans` under a root span
named after the command, read back as `opt.stage_seconds`; with
PLOIDYFROST_TRACE=<dir> each also writes its trace and spans
(util/profiling.py).

All also take `group` (parallel/mesh.Group, one rank per device; then
`device` is the rank's own). The counter, the superbubble search and
the EM split over the ranks. Rank 0 alone receives the count table,
builds the graph, replays the search, runs the sites pass and writes,
as the JAX package's one process on its mesh does; the other ranks
count, send their shard, wait at the barriers (`sync`), join the search
and fit their slice of the frequencies that rank 0 wrote
(`_join_analysis`, `_follow_pipeline`).
"""

from __future__ import annotations

import functools
import os
import sys
import time

import numpy as np

from . import resolve_device
from .io.fastx import ReadAhead
from .parallel.mesh import is_primary, make_counter, rank0_checks, rank0_decides, sync
from .util.profiling import add_count, span


def _log(msg: str):
    print(msg, flush=True)


def _command(name: str):
    """Run the decorated entry point (opt, device, group) inside the
    root span `name` of opt.spans, or inside the open span when another
    command calls it."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(opt, device="cuda", group=None):
            with opt.spans.command(name, opt.outprefix, is_primary(group)):
                return fn(opt, device, group)

        return run

    return wrap


def load_count_db(path: str, k: int):
    """Load a k-mer count table: our .npz (from `count`) or a KMC
    database prefix (.kmc_pre/.kmc_suf, io/kmc.py)."""
    from .kmer.countdb import KmerCountDB

    if path.endswith(".npz") and os.path.exists(path):
        z = np.load(path)
        if int(z["k"]) != k:
            raise SystemExit(
                f"Error: count table k={int(z['k'])} != graph k={k}"
            )
        return KmerCountDB(z["kmers"], z["counts"], k)
    if os.path.exists(path + ".npz"):
        return load_count_db(path + ".npz", k)
    if os.path.exists(path + ".kmc_pre") or path.endswith(".kmc_pre"):
        from .io.kmc import read_kmc_db

        prefix = path[: -len(".kmc_pre")] if path.endswith(".kmc_pre") else path
        km, ct, kk = read_kmc_db(prefix)
        if kk != k:
            raise SystemExit(f"Error: KMC database k={kk} != graph k={k}")
        return KmerCountDB(km, ct, k)
    raise SystemExit(f"Error: Please input the correct kmc database path: {path}")


def unitig_coverage(db, g):
    """Batched readCov(u) for every unitig (src/CDBG.cpp:66-120): mean
    and min k-mer count per unitig, resolved in one bulk probe batch
    against the sorted table (host-side by design: the probes are
    latency-bound and measured faster on host than via device
    round-trips — see kmer/countdb.py).

    The k-mer feed comes straight from the packed SeqStore (vectorized
    extraction, graph/seqstore.py) — no per-unitig string walks."""
    flat, lens = g.store.all_kmers(g.k)
    counts, hit = db.lookup(flat)
    if not hit.all():
        from .kmer.pack import decode_kmers

        missing = decode_kmers([flat[int(np.argmin(hit))]], g.k)[0]
        print(f"CDBG::readCov():{missing} kmer can not found .")
        raise SystemExit(1)
    offs = np.zeros(len(lens), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    # segment mean/min via reduceat (ufunc.at is orders slower); int64
    # segment sums are exact, so the float64 means match the former
    # float64 reduceat bit-for-bit without copying the 8B/k-mer array
    mean = np.add.reduceat(counts, offs) / lens
    mn = np.minimum.reduceat(counts, offs)
    return mean, mn


def window_coverage(db, strings: list[str], lower: int, upper: int):
    """Batched readCov(s, lower, upper) (src/CDBG.cpp:29-60): for each
    window string, (mean k-mer count, all-counts-in-(lower,upper) flag)."""
    from .kmer.pack import encode_bases
    from .graph.seqstore import SeqStore

    uniq = sorted(set(strings))
    add_count("windows", len(uniq))
    out: dict[str, tuple[float, bool]] = {}
    if not uniq:
        return out
    # one vectorized encode + word-gather k-mer extraction over the
    # whole window corpus (the per-window string_kmers_np loop costs
    # ~130 us/window in python)
    lens = np.array([len(s) - db.k + 1 for s in uniq], dtype=np.int64)
    offs = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    wstore = SeqStore.from_codes(
        encode_bases("".join(uniq)),
        np.array([len(s) for s in uniq], dtype=np.int64),
    )
    flat, _ = wstore.all_kmers(db.k)
    counts, hit = db.lookup(flat)
    if not hit.all():
        from .kmer.pack import decode_kmers

        missing = decode_kmers([flat[int(np.argmin(hit))]], db.k)[0]
        print(f"CDBG::readCov():{missing} kmer can not found .")
        raise SystemExit(1)
    inb = (counts > lower) & (counts < upper)
    starts = offs[:-1]
    ok = np.minimum.reduceat(inb.view(np.uint8), starts) > 0
    mean = np.add.reduceat(counts, starts) / lens
    for i, s in enumerate(uniq):
        out[s] = (float(mean[i]), bool(ok[i]))
    return out


def load_color_matrix(path: str, g):
    """Load unitig colors: our .colors.npz (packed bit matrix) or a
    Bifrost .bfg_colors binary (io/bfg.py reader)."""
    from .graph.colors import ColorMatrix

    if path.endswith(".npz"):
        z = np.load(path, allow_pickle=False)
        bits = np.unpackbits(z["bits"], axis=0)[: int(z["rows"])].astype(bool)
        names = [str(n) for n in z["names"]]
        offsets = z["offsets"]
        return ColorMatrix(offsets, bits, names)
    from .io.bfg import read_bfg_colors

    return read_bfg_colors(path, g)


def save_color_matrix(path: str, colors) -> None:
    np.savez(
        path,
        bits=np.packbits(colors.bits.astype(np.uint8), axis=0),
        rows=colors.bits.shape[0],
        offsets=colors.offsets,
        names=np.array(colors.names),
    )


def write_graph_info_colored(g, colors, outpre: str, verbose: bool):
    """CCDBG::printInfo (src/CCDBG.cpp:2022-2053): graph info plus
    NbColors and one color name per line."""
    lines = (
        f"k:{g.k}\tg:{g.g}\tNbColors:{colors.n_colors}\t"
        f"nbKmer:{g.nb_kmers()}\tnbUnitig:{len(g)}\tlength:{g.total_length()}\n"
        + "".join(c + "\n" for c in colors.names)
    )
    if verbose:
        _log(">>>>>>>>>Graph Information>>>>>>>>>")
        print(lines, end="")
        _log(">>>>>>>>>>>>>>>>>>>>>>>>>>>>>>>>>>>")
    with open(outpre + "_graph_info.txt", "w") as f:
        f.write(lines)


@_command("run")
def run_colored_analysis(opt, device="cuda", group=None) -> int:
    """The colored main run (src/Main.cpp:777-813): ColoredCDBG read,
    per-color KMC database open, setUnitigId, findSuperBubble,
    colored ploidyEstimation."""
    dev = resolve_device(device)
    if not is_primary(group):
        return _join_analysis(opt, group)
    from .bubble.batched import find_superbubbles_device as find_superbubbles
    from .bubble.superbubble import write_superbubble_file
    from .graph.cdbg import CDBGraph
    from .sites.emit_colored import (
        analyze_bubbles_colored,
        unitig_coverage_colored,
        window_coverage_colored,
        write_outputs_colored,
    )

    with rank0_checks(group):
        with span("load_graph") as s:
            _log(f"Loading colored graph from {opt.graphfile} + {opt.colorfile}")
            g = CDBGraph.from_gfa(opt.graphfile)
            colors = load_color_matrix(opt.colorfile, g)

            # one count database per color, listed one prefix per line in
            # opt.db (src/CCDBG.cpp:11-88)
            dbs = []
            with span("load_table"), open(opt.db) as f:
                for line in f:
                    name = line.rstrip("\n")
                    if name:
                        dbs.append(load_count_db(name, g.k))
                        _log(f"CCDBG::CCDBG(): database {name} initialized")
        _log(f"CCDBG: Graph loading Real time : {s.seconds}s")
        if len(dbs) != colors.n_colors:
            raise SystemExit(
                f"Error: {len(dbs)} databases != {colors.n_colors} colors"
            )
        cutoffs = list(opt.coverage_vec)
        if len(cutoffs) != len(dbs):
            raise SystemExit(
                f"Error: {len(cutoffs)} coverage cutoffs != {len(dbs)} databases"
            )
    rank0_decides(group)  # the inputs are good: the other ranks go on to the search
    for i, (lo, up) in enumerate(cutoffs):
        _log(f"CCDBG:: Database {i} Minimum Coverage:{lo}")
        _log(f"CCDBG:: Maximum Coverage:{up}")

    os.makedirs("PloidyFrost_output", exist_ok=True)
    g.set_unitig_id(opt.outprefix)
    write_graph_info_colored(g, colors, opt.outprefix, opt.verbose)

    # overlap host coverage probes + corpus decode with the device
    # search (same latency-hiding as run_analysis; the reference
    # interleaves readCovUni with the walk across pthreads,
    # src/CCDBG.cpp:583-1449)
    from concurrent.futures import ThreadPoolExecutor

    root = opt.spans.current()

    def _cov_and_decode():
        with opt.spans.span("coverage", parent=root):
            out = unitig_coverage_colored(dbs, g, cutoffs)
            g.seqs.materialize()
        return out

    pool = ThreadPoolExecutor(max_workers=1)
    cov_future = pool.submit(_cov_and_decode)

    _log("CCDBG::findSuperBubble(): Finding superbubbles")
    try:
        with span("superbubbles") as s:
            state, bubbles = find_superbubbles(
                g, opt.complex_size, colors, device=dev, group=group
            )
            with span("replay"):
                write_superbubble_file(g, bubbles, opt.outprefix)
    except BaseException:
        pool.shutdown()
        raise
    _log(f"CCDBG::findSuperBubble(): Real time : {s.seconds}s")
    _log(f"CCDBG::findSuperBubble(): {len(bubbles)}  SuperBubbles Found")
    # reference parity: check_ProgramOptions FORCES bubble=true and p
    # defaults true with no way to unset, so a run always continues to
    # ploidyEstimation; -b is accepted but changes nothing
    # (src/Main.cpp:463, 92-120, 836-850)

    _log(
        "CCDBG::PloidyEstimation():  Analyzing superbubbles to generate sites' information"
    )
    with span("sites") as s:
        with span("coverage_wait"):
            try:
                umean, uok = cov_future.result()
            finally:
                pool.shutdown()
        with span("align"):
            emissions, window_strings, window_colors = analyze_bubbles_colored(
                g, colors, state, umean, uok, opt.match, opt.mismatch, opt.gap,
                device=dev,
            )
        with span("window_coverage"):
            wcov = window_coverage_colored(dbs, window_strings, cutoffs)
        with span("write_tables"):
            stats = write_outputs_colored(
                emissions, wcov, window_colors, colors.n_colors, opt.outprefix
            )
    _log(f"CCDBG::PloidyEstimation(): Real time : {s.seconds}s")
    a = stats["allele"]
    _log(
        "CCDBG::PloidyEstimation(): Alleles in SuperBubbles  :\t"
        f"2 :{a[0]}\t3 :{a[1]}\t4 :{a[2]}\t5 :{a[3]}"
    )
    if stats["core_num"]:
        _log(
            "CCDBG::PloidyEstimation(): Sites' Average Coverage:"
            f"{stats['core_cov'] // stats['core_num']}"
        )
    return 0


@_command("run")
def run_analysis(opt, device="cuda", group=None) -> int:
    """The reference main run (src/Main.cpp:764-853): graph load,
    setUnitigId, findSuperBubble, ploidyEstimation."""
    dev = resolve_device(device)
    if not is_primary(group):
        return _join_analysis(opt, group)
    from .bubble.batched import find_superbubbles_device as find_superbubbles
    from .bubble.superbubble import write_superbubble_file
    from .graph.cdbg import CDBGraph
    from .sites.emit import analyze_bubbles, write_outputs

    with rank0_checks(group):
        with span("load_graph") as s:
            _log(f"Loading graph from {opt.graphfile}")
            try:
                g = CDBGraph.from_gfa(opt.graphfile)
            except FileNotFoundError:
                print(f"Error: Graph file not found: {opt.graphfile}", file=sys.stderr)
                return rank0_decides(group, 1)
        _log(f"Graph loading Real time : {s.seconds}s")
        if opt.k and g.k != opt.k and opt.k != 25:
            _log(f"warning: graph k={g.k} overrides -k {opt.k}")

        with span("load_table"):
            db = load_count_db(opt.db, g.k)
    rank0_decides(group)  # the inputs are good: the other ranks go on to the search

    os.makedirs("PloidyFrost_output", exist_ok=True)
    g.set_unitig_id(opt.outprefix)
    g.write_graph_info(opt.outprefix)
    if opt.verbose:
        _log(">>>>>>>>>Graph Information>>>>>>>>>")
        _log(
            f"k:{g.k}\tg:{g.g}\tnbKmer:{g.nb_kmers()}\t"
            f"nbUnitig:{len(g)}\tlength:{g.total_length()}\t"
        )

    # overlap the host-side coverage probes (unitig_coverage: native
    # threaded table scans that release the GIL) with the device
    # superbubble search. The reference interleaves readCov with its
    # bubble walk across pthreads (src/CDBG.cpp:1917-2642); this is the
    # same latency-hiding, expressed as one background host task under
    # the device phase. The unitig-string decode the analysis walk needs
    # (SeqStore.materialize) rides the same task.
    from concurrent.futures import ThreadPoolExecutor

    root = opt.spans.current()

    def _cov_and_decode():
        with opt.spans.span("coverage", parent=root):
            out = unitig_coverage(db, g)
            g.seqs.materialize()  # pre-decode for the analysis walk
        return out

    pool = ThreadPoolExecutor(max_workers=1)
    cov_future = pool.submit(_cov_and_decode)

    _log("findSuperBubble(): Finding superbubbles")
    with span("superbubbles") as s:
        state, bubbles = find_superbubbles(g, opt.complex_size, device=dev, group=group)
        with span("replay"):
            write_superbubble_file(g, bubbles, opt.outprefix)
    _log(f"findSuperBubble(): Real time : {s.seconds}s")
    _log(f"findSuperBubble(): {len(bubbles)}  SuperBubbles Found")
    # reference parity: -b never stops the run (src/Main.cpp:463, 836-850)

    _log("PloidyEstimation(): Analyzing superbubbles to generate sites' information")
    with span("sites") as s:
        with span("coverage_wait"):
            try:
                ucov, umin = cov_future.result()
            finally:
                pool.shutdown()
        with span("align"):
            emissions, window_strings = analyze_bubbles(
                g,
                state,
                ucov,
                umin,
                opt.coverage_lower,
                opt.coverage_upper,
                opt.match,
                opt.mismatch,
                opt.gap,
                device=dev,
            )
        with span("window_coverage"):
            wcov = window_coverage(
                db, window_strings, opt.coverage_lower, opt.coverage_upper
            )
        with span("write_tables"):
            stats = write_outputs(emissions, wcov, opt.outprefix)
    _log(f"PloidyEstimation(): Real time : {s.seconds}s")
    a = stats["allele"]
    _log(
        "PloidyEstimation(): Alleles in SuperBubbles  :\t"
        f"2 :{a[0]}\t3 :{a[1]}\t4 :{a[2]}\t5 :{a[3]}"
    )
    if stats["core_num"]:
        _log(
            "PloidyEstimation(): Sites' Average Coverage:"
            f"{stats['core_cov'] // stats['core_num']}"
        )
    return 0


def count_sample(reader, i: int, dev, group=None):
    """Count sample i of `reader` (io/fastx.ReadAhead) on `dev`, or over
    `group`'s ranks (each reads every batch and counts its slice, then
    enters the finalization: the histogram's reduction and its shard's
    send to rank 0). Returns the counter; each wait for the reader is a
    `read` span, and the reader's counts of the sample land on the open
    span."""
    counter = make_counter(reader.k, dev, group)
    batches = reader.sample(i)
    while True:
        with span("read"):
            batch = next(batches, None)
        if batch is None:
            break
        counter.add_reads(batch)
    for key, n in reader.counts[i].items():
        add_count(key, n)
    if group is not None:
        counter.finalize()
    return counter


def _log_ranks(group, times: dict, log: list) -> None:
    """On a group: rank 0 logs one line a rank with its K1, search-kernel
    and EM-kernel launches, the seconds from its process's start to its
    group join and of the join itself, its peak device memory, its
    counter flushes (`log`: ShardedKmerCounter.flush_log entries, key
    bytes sent and route + merge seconds) and the seconds of the stages
    it ran (`times`; `finalize`, the table's way to rank 0, is part of
    `count`)."""
    if group is None:
        return
    import torch
    import torch.distributed as dist

    from .bubble import batched
    from .kmer import extract
    from .model import gmm

    mine = {"K1 launches": extract.LAUNCHES, "search launches": batched.SEARCH_LAUNCHES,
            "EM launches": gmm.EM_LAUNCHES}
    if group.start_s is not None:
        mine["start to join s"] = round(group.start_s, 4)
    mine["group init s"] = round(group.init_s, 4)
    if group.device.type == "cuda":
        mine["peak device MiB"] = round(torch.cuda.max_memory_allocated(group.device) / 2**20, 1)
    mine.update({"flushes": len(log), "all_to_all bytes": sum(b for b, _ in log),
                 "route+merge s": round(sum(t for _, t in log), 4),
                 **{f"{k} s": round(v, 4) for k, v in times.items()}})
    rows = [None] * group.world
    dist.all_gather_object(rows, mine)
    if group.rank == 0:
        for r, row in enumerate(rows):
            _log(f"rank {r}: " + ", ".join(f"{k} {v}" for k, v in row.items()))


def _join_analysis(opt, group) -> int:
    """run_analysis and run_colored_analysis on a rank other than 0: wait
    for rank 0's verdict on its inputs (`wait` seconds), then search this
    rank's slice of the seeds that rank 0 broadcasts (`superbubbles`).
    Rank 0 alone loads the graph, replays and runs the sites pass."""
    from .bubble.batched import search_seeds

    with span("wait"):
        rc = rank0_decides(group)
    if rc:
        return rc
    with span("superbubbles"):
        search_seeds(None, None, group=group)
    return 0


def _fit_model(opt, dev, group) -> float:
    """The pipelines' model stage on the allele frequencies that rank 0
    wrote: gauss 1..9, every rank fitting its slice over a group."""
    from .model.gmm import run_model

    return run_model(
        opt.outprefix,
        fre_file=os.path.join(
            "PloidyFrost_output", opt.outprefix + "_allele_frequency.txt"
        ),
        gauss_lower=1,
        gauss_upper=9,
        frequency=0.0,
        max_iter=1000,
        delta=opt.delta,
        m_threshold=opt.mthreshold,
        n_threshold=opt.nthreshold,
        device=dev,
        group=group,
    )


def _follow_pipeline(opt, dev, group, samples) -> int:
    """`pipeline` and `pipeline-multi` on a rank other than 0: count each
    sample (a list of files) and send the shard to rank 0, wait while
    rank 0 builds and writes the graph, join the search, and fit this
    rank's slice of the allele frequencies once rank 0 has written them.
    Its stage seconds: read, count (finalize within it), inflate (the
    reader's workers), wait (at the barriers and for rank 0's verdict),
    superbubbles (its part of the search) and model."""
    flushes = []
    with ReadAhead(samples, opt.k, trim=opt.trim) as reader:
        for i in range(len(samples)):
            with span("count"):
                counter = count_sample(reader, i, dev, group=group)
            flushes += counter.flush_log
            del counter  # frees the shard and the buffer
    with span("wait"):
        sync(group)  # rank 0 built and wrote the graph
    rc = _join_analysis(opt, group)
    if rc:
        return rc
    with span("wait"):
        sync(group)  # the allele frequency table is on disk
    with span("model"):
        _fit_model(opt, dev, group)
    _log_ranks(group, opt.stage_seconds, flushes)
    return 0


def _link_device(opt, dev):
    """The device of the graph-construction link step: `dev` under
    --device-build, else None (the native host kernel)."""
    return dev if opt.device_build else None


def build_graph_cli(opt, device="cuda", group=None) -> int:
    """Native compacted-DBG construction from reads (replaces
    `Bifrost build -i -d -k`, script/pipeline/4.bifrost:4)."""
    dev = resolve_device(device)
    from .graph.construct import build_graph_from_reads

    if not opt.inputs:
        print("Error: no input reads", file=sys.stderr)
        return 1
    t0 = time.time()
    g, counter = build_graph_from_reads(
        opt.inputs,
        opt.k,
        min_count=max(1, opt.coverage_lower if opt.hist else 1),
        device=dev,
        link_device=_link_device(opt, dev),
        group=group,
    )
    if not is_primary(group):
        return 0
    _log(
        f"build: {len(g)} unitigs, {g.nb_kmers()} kmers, "
        f"{g.total_length()} bp in {time.time() - t0:.1f}s"
    )
    g.write_gfa(opt.outprefix + ".gfa")
    return 0


def build_colored_graph_cli(opt, device="cuda", group=None) -> int:
    """Native COLORED compacted-DBG construction (replaces
    `Bifrost build -i -d -k 25 -c`, script/pipeline/run-multisample.sh).
    Each positional argument is one sample (comma-separated files);
    writes {outprefix}.gfa + {outprefix}.colors.npz."""
    dev = resolve_device(device)
    from .graph.colors import color_graph
    from .graph.construct import build_graph_from_kmers, simplify
    from .kmer.countdb import sorted_union

    if not opt.inputs:
        print("Error: no input samples", file=sys.stderr)
        return 1
    primary = is_primary(group)
    t0 = time.time()
    samples = [s.split(",") for s in opt.inputs]
    sample_kmers = []
    with ReadAhead(samples, opt.k) as reader:
        for i in range(len(samples)):
            counter = count_sample(reader, i, dev, group=group)
            if primary:
                sample_kmers.append(counter.arrays()[0])
    names = [files[0] for files in samples]
    if not primary:
        return 0
    g = simplify(
        build_graph_from_kmers(
            sorted_union(sample_kmers), opt.k, link_device=_link_device(opt, dev)
        ),
        opt.k,
    )
    colors = color_graph(g, sample_kmers, names)
    _log(
        f"build -c: {len(g)} unitigs, {g.nb_kmers()} kmers, "
        f"{colors.n_colors} colors in {time.time() - t0:.1f}s"
    )
    g.write_gfa(opt.outprefix + ".gfa")
    save_color_matrix(opt.outprefix + ".colors.npz", colors)
    return 0


@_command("pipeline-multi")
def run_multisample_pipeline_cli(opt, device="cuda", group=None) -> int:
    """Native end-to-end multi-sample run (replaces
    script/pipeline/run-multisample.sh): per-sample count + cutoffs ->
    masked k-mer union -> colored graph -> colored analysis -> model.
    Every stage boundary is a durable artifact. Stage spans: `read` and
    `count` for each sample, `build_graph` for each sample (table fetch
    and save) and once more for the union, graph, coloring
    (`color_graph`) and output."""
    dev = resolve_device(device)
    from .graph.colors import color_graph
    from .graph.construct import build_graph_from_kmers, simplify
    from .kmer.countdb import sorted_union
    from .kmer.cutoffs import cutoff_lower_from_counts, cutoff_upper_from_counts

    if not opt.inputs:
        print("Error: no input samples", file=sys.stderr)
        return 1
    samples = [s.split(",") for s in opt.inputs]
    if not is_primary(group):
        return _follow_pipeline(opt, dev, group, samples)
    flushes = []
    pre = opt.outprefix
    filtered = []
    names = []
    cutoffs = []
    db_list_path = pre + ".kmc_list.txt"
    # every sample's files are read ahead from here on, the next sample's
    # while this one is counted, its table fetched and saved
    with open(db_list_path, "w") as dblist, open(pre + ".coverage_cutoff.txt", "w") as covfile, \
            ReadAhead(samples, opt.k, trim=opt.trim) as reader:
        for i, files in enumerate(samples):
            with span("count"):
                counter = count_sample(reader, i, dev, group=group)
                hist = counter.histogram(10000)
                counter.write_histogram(f"{pre}.s{i}.hist.txt")
            with span("build_graph"):
                lower = max(10, cutoff_lower_from_counts(list(hist[1:])))
                upper = cutoff_upper_from_counts(list(hist[1:]), opt.frequency)
                _log(f"pipeline-multi: sample {i} cutoffs L={lower} U={upper}")
                with span("table_d2h"):
                    km, ct = counter.arrays()
                if group is not None:
                    flushes += counter.flush_log
                del counter  # frees the sample's device table and buffer
                with span("write_graph"):
                    np.savez(f"{pre}.s{i}.kmers.npz", kmers=km, counts=ct, k=opt.k)
                dblist.write(f"{pre}.s{i}.kmers.npz\n")
                covfile.write(f"{lower}\t{upper}\n")
                cutoffs.append((lower, upper))
                # per-sample masking: keep k-mers with count >= lower
                # (kmc_tools filter -ci<lower>, script/pipeline/3.filter)
                filtered.append(km[ct >= lower])
                names.append(files[0])
    with span("build_graph"):
        with span("link"):
            union = sorted_union(filtered)
        g = simplify(
            build_graph_from_kmers(union, opt.k, link_device=_link_device(opt, dev)), opt.k
        )
        del union
        with span("color_graph"):
            colors = color_graph(g, filtered, names)
        with span("write_graph"):
            g.write_gfa(pre + ".gfa")
            save_color_matrix(pre + ".colors.npz", colors)
        sync(group)  # the graph, colors and count tables are on disk
    opt.graphfile = pre + ".gfa"
    opt.colorfile = pre + ".colors.npz"
    opt.db = db_list_path
    opt.coverage_vec = cutoffs
    rc = run_colored_analysis(opt, dev, group)
    if rc:
        return rc
    sync(group)  # the allele frequency table is on disk
    with span("model"):
        ploidy = _fit_model(opt, dev, group)
    _log(f"estimated ploidy level is : {int(ploidy)}")
    _log_ranks(group, opt.stage_seconds, flushes)
    return 0


@_command("pipeline")
def run_pipeline_cli(opt, device="cuda", group=None) -> int:
    """reads -> count -> graph -> bubbles -> variants -> model, one shot
    (replaces script/pipeline/run.sh). Returns 0, or 1 on bad input."""
    dev = resolve_device(device)
    from .graph.construct import build_graph_from_kmers, simplify
    from .kmer.cutoffs import cutoff_lower_from_counts, cutoff_upper_from_counts

    if not opt.inputs:
        print("Error: no input reads", file=sys.stderr)
        return 1
    if not is_primary(group):
        return _follow_pipeline(opt, dev, group, [opt.inputs])

    with span("count"):
        with ReadAhead([opt.inputs], opt.k, trim=opt.trim) as reader:
            counter = count_sample(reader, 0, dev, group=group)
        flushes = counter.flush_log if group is not None else []
        hist = counter.histogram(10000)
        counter.write_histogram(opt.outprefix + ".hist.txt")
    lower = max(10, cutoff_lower_from_counts(list(hist[1:])))
    upper = cutoff_upper_from_counts(list(hist[1:]), opt.frequency)
    _log(f"pipeline: cutoffs L={lower} U={upper}")
    opt.coverage_lower = lower
    opt.coverage_upper = upper

    with span("build_graph"):
        with span("table_d2h"):
            km, ct = counter.arrays()
        # graph on k-mers >= lower cutoff = the reference's read-masking
        # stage (kmc_tools filter -ci<lower>, script/pipeline/3.filter)
        g = simplify(
            build_graph_from_kmers(
                km[ct >= lower], opt.k, link_device=_link_device(opt, dev)
            ),
            opt.k,
        )
        with span("write_graph"):
            g.write_gfa(opt.outprefix + ".gfa")
            np.savez(opt.outprefix + ".kmers.npz", kmers=km, counts=ct, k=opt.k)
        sync(group)  # the graph and the count table are on disk
    opt.graphfile = opt.outprefix + ".gfa"
    opt.db = opt.outprefix + ".kmers.npz"
    rc = run_analysis(opt, dev, group)
    if rc:
        return rc
    sync(group)  # the allele frequency table is on disk
    with span("model"):
        ploidy = _fit_model(opt, dev, group)
    _log(f"estimated ploidy level is : {int(ploidy)}")
    _log_ranks(group, opt.stage_seconds, flushes)
    return 0
