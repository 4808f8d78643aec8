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


def _analyze(opt, g, dev, group, colors, pre: str, coverage, align, windows, write) -> int:
    """The rest of `run` on rank 0 once the inputs are loaded, for one
    sample (`colors` None) and for several: the coverage probes on a
    thread beside the superbubble search, then the sites pass
    (`align(state, coverage's result)`, `windows(its window strings)`,
    `write(emissions, window coverage, *what else align returned)`, each
    in its span), with the reference's log lines prefixed `pre`.

    The reference interleaves readCov with its bubble walk across
    pthreads (src/CDBG.cpp:1917-2642, src/CCDBG.cpp:583-1449); here the
    host-side probes (native threaded table scans that release the GIL)
    and the unitig-string decode the walk needs (SeqStore.materialize)
    run as one background task under the search."""
    from concurrent.futures import ThreadPoolExecutor

    from .bubble.batched import find_superbubbles_device
    from .bubble.superbubble import write_superbubble_file

    root = opt.spans.current()

    def _cov_and_decode():
        with opt.spans.span("coverage", parent=root):
            out = coverage()
            g.seqs.materialize()  # pre-decode for the analysis walk
        return out

    with ThreadPoolExecutor(max_workers=1) as pool:
        cov_future = pool.submit(_cov_and_decode)
        _log(f"{pre}findSuperBubble(): Finding superbubbles")
        with span("superbubbles") as s:
            state, bubbles = find_superbubbles_device(
                g, opt.complex_size, colors, device=dev, group=group
            )
            with span("replay"):
                write_superbubble_file(g, bubbles, opt.outprefix)
        _log(f"{pre}findSuperBubble(): Real time : {s.seconds}s")
        _log(f"{pre}findSuperBubble(): {len(bubbles)}  SuperBubbles Found")
        # reference parity: check_ProgramOptions FORCES bubble=true and p
        # defaults true with no way to unset, so a run always continues to
        # ploidyEstimation; -b is accepted but changes nothing
        # (src/Main.cpp:463, 92-120, 836-850)

        # the colored reference prints two spaces before "Analyzing"
        _log(
            f"{pre}PloidyEstimation():{'  ' if pre else ' '}"
            "Analyzing superbubbles to generate sites' information"
        )
        with span("sites") as s:
            with span("coverage_wait"):
                cov = cov_future.result()
            with span("align"):
                emissions, window_strings, *more = align(state, cov)
            with span("window_coverage"):
                wcov = windows(window_strings)
            with span("write_tables"):
                stats = write(emissions, wcov, *more)
    _log(f"{pre}PloidyEstimation(): Real time : {s.seconds}s")
    a = stats["allele"]
    _log(
        f"{pre}PloidyEstimation(): Alleles in SuperBubbles  :\t"
        f"2 :{a[0]}\t3 :{a[1]}\t4 :{a[2]}\t5 :{a[3]}"
    )
    if stats["core_num"]:
        _log(
            f"{pre}PloidyEstimation(): Sites' Average Coverage:"
            f"{stats['core_cov'] // stats['core_num']}"
        )
    return 0


@_command("run")
def run_colored_analysis(opt, device="cuda", group=None) -> int:
    """The colored main run (src/Main.cpp:777-813): ColoredCDBG read,
    per-color KMC database open, setUnitigId, findSuperBubble,
    colored ploidyEstimation."""
    dev = resolve_device(device)
    if not is_primary(group):
        return _join_analysis(opt, group)
    from .graph.cdbg import CDBGraph
    from .sites import emit_colored as ec

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
    return _analyze(
        opt, g, dev, group, colors, "CCDBG::",
        coverage=lambda: ec.unitig_coverage_colored(dbs, g, cutoffs),
        align=lambda state, cov: ec.analyze_bubbles_colored(
            g, colors, state, *cov, opt.match, opt.mismatch, opt.gap, device=dev
        ),
        windows=lambda strings: ec.window_coverage_colored(dbs, strings, cutoffs),
        write=lambda emissions, wcov, window_colors: ec.write_outputs_colored(
            emissions, wcov, window_colors, colors.n_colors, opt.outprefix
        ),
    )


@_command("run")
def run_analysis(opt, device="cuda", group=None) -> int:
    """The reference main run (src/Main.cpp:764-853): graph load,
    setUnitigId, findSuperBubble, ploidyEstimation."""
    dev = resolve_device(device)
    if not is_primary(group):
        return _join_analysis(opt, group)
    from .graph.cdbg import CDBGraph
    from .sites import emit

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
    lower, upper = opt.coverage_lower, opt.coverage_upper
    # each sites function is looked up on its module at the call, where
    # tests replace it
    return _analyze(
        opt, g, dev, group, None, "",
        coverage=lambda: emit.unitig_coverage(db, g),
        align=lambda state, cov: emit.analyze_bubbles(
            g, state, *cov, lower, upper, opt.match, opt.mismatch, opt.gap, device=dev
        ),
        windows=lambda strings: emit.window_coverage(db, strings, lower, upper),
        write=lambda emissions, wcov: emit.write_outputs(emissions, wcov, opt.outprefix),
    )


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
