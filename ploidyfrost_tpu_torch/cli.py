# Ported from ploidyfrost_tpu/cli.py.
"""Command-line interface of the PyTorch/CUDA port.

Mirrors the reference binary's surface (src/Main.cpp:11-84):

    ploidyfrost-tpu-torch [-g graph.gfa -d countdb -o pre ...]     # main run
    ploidyfrost-tpu-torch [-g graph.gfa -f colors -d dblist -C cutoffs ...]
                                                        # colored main run
    ploidyfrost-tpu-torch model    [-f covprefix | -g frefile] ...
    ploidyfrost-tpu-torch cutoffL  <hist>
    ploidyfrost-tpu-torch cutoffU  <hist> [quantile]

plus native subcommands replacing the external stages the reference
delegates to KMC / Bifrost (script/pipeline/2.kmc_db, 4.bifrost):

    ploidyfrost-tpu-torch count    -k 25 -o db reads.fq [reads2.fq ...]
    ploidyfrost-tpu-torch build    -k 25 -o graph reads.fq ...
    ploidyfrost-tpu-torch build -c -k 25 -o graph s1.fq s2.fq ...  # colored
    ploidyfrost-tpu-torch pipeline -o pre reads.fq ...             # end-to-end
    ploidyfrost-tpu-torch pipeline-multi -o pre s1.fq s2.fq ...    # colored

and the R post-processing layer (script/Filter.R, Filter-multi.R,
Drawfreq.R, paper_figures.R) as native subcommands:

    ploidyfrost-tpu-torch filter       -i pre -o filtered [-l low -u up -S -I -P ...]
    ploidyfrost-tpu-torch filter-multi -i pre -o filtered [-c color -v cramer ...]
    ploidyfrost-tpu-torch drawfreq     -f frefile -o out [-t title -p ploidy]
    ploidyfrost-tpu-torch figures -i pre -o out -c cov[,..] -p ploidy
                    [--multi] [--cramer T] [--names a,b,..] [--no-model]
                    [--gauss-low L --gauss-up U]   # paper_figures.R workflow

`filter` sits between the main run and `model`, as in the reference's
workflow. `drawfreq` and the pictures of `figures` need matplotlib;
without it they print one line and return 1 (`figures` after writing
its two .tsv tables, whose GMM fits run on --device).

A count database (-d) is a .kmers.npz from `count` or a KMC prefix
(.kmc_pre/.kmc_suf); colors (-f) are a .colors.npz from `build -c` or
a Bifrost .bfg_colors file. In `build -c` and `pipeline-multi` each
positional argument is one sample (comma-separated files).

Long flags (any subcommand):

    --device=cuda|cpu  where the device work runs (default cuda; without
                       a CUDA device the command fails unless --device=cpu)
    --device-build     sort the junction keys of graph construction on
                       that device instead of in the native host kernel
                       (build, build -c, pipeline, pipeline-multi); the
                       graph is the same either way
    --devices[=N]      run on N devices, one rank (process) each: rank r
                       on cuda:r with NCCL, or on the CPU with gloo under
                       --device=cpu. Without N, or without the flag, the
                       PLOIDYFROST_DEVICES variable (N or "auto") decides,
                       and auto is every visible card when there are
                       several (1 on --device=cpu). Counting, the
                       superbubble search and the EM split over the ranks;
                       every rank computes the same tables and rank 0
                       writes them, byte-identical to one device's. The
                       multi-host variables (PLOIDYFROST_COORDINATOR,
                       _NUM_PROCESSES, _PROCESS_ID, _LOCAL_DEVICES) are
                       the JAX package's; see parallel/mesh.py
    --trim[=SPEC]      quality-trim FASTQ reads before counting
                       (Trimmomatic-style; default SPEC =
                       LEADING:10,TRAILING:10,SLIDINGWINDOW:3:20,MINLEN:50,
                       the reference pipeline's arguments; applied in the
                       native C reader)

Option letters, defaults and validation follow src/Main.cpp:92-199,
including the getopt fallthrough where `-u X` ALSO assigns the coverage
file (src/Main.cpp:149-153).
"""

from __future__ import annotations

import sys

from .util.profiling import Spans


def _getopt(argv, optstring):
    """Minimal POSIX getopt clone matching the reference's parse loop."""
    opts = []
    args = []
    takes_arg = {}
    i = 0
    while i < len(optstring):
        c = optstring[i]
        if i + 1 < len(optstring) and optstring[i + 1] == ":":
            takes_arg[c] = True
            i += 2
        else:
            takes_arg[c] = False
            i += 1
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and len(a) > 1 and a != "--":
            c = a[1]
            if c not in takes_arg:
                raise ValueError(f"Invalid option -{c}")
            if takes_arg[c]:
                if len(a) > 2:
                    opts.append((c, a[2:]))
                else:
                    i += 1
                    opts.append((c, argv[i]))
            else:
                opts.append((c, None))
                # grouped no-arg flags: -iv
                for extra in a[2:]:
                    if extra not in takes_arg or takes_arg[extra]:
                        raise ValueError(f"Invalid option -{extra}")
                    opts.append((extra, None))
        else:
            args.append(a)
        i += 1
    return opts, args


class Options:
    """Defaults mirror the reference Options struct (src/Main.cpp:92-120)."""

    def __init__(self):
        self.graphfile = ""
        self.colorfile = ""
        self.nb_threads = 1
        self.verbose = False
        self.coverage_lower = 10
        self.coverage_upper = 1000
        self.complex_size = 8
        self.coveragefile = ""
        self.frequency = 0.998
        self.outprefix = "output"
        self.k = 25
        self.info = False
        self.db = ""
        self.bubble = False
        self.delta = 0.01
        self.coverage_vec = []
        self.hist = ""
        self.p = True
        self.mthreshold = 5.0
        self.nthreshold = 2.0
        self.match = 2.0
        self.mismatch = -1.0
        self.gap = -3.0
        self.inputs = []
        self.colored = False
        self.trim = None
        # --device-build: junction sort of graph construction on the device
        self.device_build = False
        # the spans of the command that runs with these options
        # (pipeline, pipeline-multi, run; util/profiling.py)
        self.spans = Spans()

    @property
    def stage_seconds(self) -> dict:
        """Wall seconds of each stage of the command, read from `spans`."""
        return self.spans.stage_seconds()


_OPTSTRING = "M:D:G:z:a:l:q:u:e:C:R:o:t:g:f:k:d:m:n:h:ibvpNSc"


def parse_options(argv, opt: Options, extras: str = ""):
    """Parse reference-style options into ``opt``.

    ``extras`` lists option letters that are valid for THIS subcommand
    beyond the reference handler set — e.g. ``-c`` for our native
    ``build``/``pipeline`` subcommands (the Bifrost CLI's colored flag,
    bifrost/src/Bifrost.cpp). Letters declared in the reference
    optstring but with no case handler (-e/-R/-N/-S, and -c outside
    build) fall through to the reference's ``default:`` which prints
    "Invalid option" + usage and exits (src/Main.cpp:124, 193-197);
    we replicate that by raising ValueError("Invalid option ...").
    """
    opts, args = _getopt(argv, _OPTSTRING)
    opt.inputs = args
    for c, v in opts:
        if c == "z":
            opt.complex_size = int(v)
        elif c == "q":
            opt.frequency = float(v)
        elif c == "m":
            opt.mthreshold = float(v)
        elif c == "n":
            opt.nthreshold = float(v)
        elif c == "M":
            opt.match = float(v)
        elif c == "D":
            opt.mismatch = float(v)
        elif c == "G":
            opt.gap = float(v)
        elif c == "u":
            # reference fallthrough: -u also sets coveragefile
            # (src/Main.cpp:149-153)
            opt.coverage_upper = int(v)
            opt.coveragefile = v
        elif c == "C":
            opt.coveragefile = v
        elif c == "a":
            opt.delta = float(v)
        elif c == "h":
            opt.hist = v
        elif c == "g":
            opt.graphfile = v
        elif c == "f":
            opt.colorfile = v
        elif c == "o":
            opt.outprefix = v
        elif c == "l":
            opt.coverage_lower = int(v)
        elif c == "t":
            opt.nb_threads = int(v)
        elif c == "k":
            opt.k = int(v)
        elif c == "v":
            opt.verbose = True
        elif c == "d":
            opt.db = v
        elif c == "i":
            opt.info = True
        elif c == "b":
            opt.bubble = True
        elif c == "p":
            opt.p = True
        elif c == "c" and "c" in extras:
            opt.colored = True
        else:
            raise ValueError(f"Invalid option -{c}")
    return opt


def _atoll(s: str) -> int:
    """C atoll: parse the leading integer, 0 if none."""
    import re

    m = re.match(r"\s*[+-]?\d+", s)
    return int(m.group()) if m else 0


def parse_coverage_vec(opt) -> None:
    """Colored cutoff resolution (src/Main.cpp:352-447): -h = file
    listing per-color histogram files; -C = file of 'lower<TAB>upper'
    lines (atoll parsing)."""
    from .kmer.cutoffs import cutoff_lower, cutoff_upper

    opt.coverage_vec = []
    if opt.hist:
        with open(opt.hist) as f:
            for line in f:
                name = line.rstrip("\n")
                if not name:
                    continue
                lo = max(10, cutoff_lower(name))
                up = cutoff_upper(name, opt.frequency)
                if lo > up:
                    raise SystemExit(
                        "Error: lower cutoff need be smaller than upper cutoff "
                    )
                opt.coverage_vec.append((lo, up))
    elif opt.coveragefile:
        with open(opt.coveragefile) as f:
            for line in f:
                name = line.rstrip("\n")
                if not name:
                    continue
                if "\t" not in name:
                    raise SystemExit("Error: Coverage File is badly Formatted.")
                pos = name.find("\t")
                lo = _atoll(name[:pos])
                up = _atoll(name[pos + 1 :])
                if lo < 0 or up < 0:
                    raise SystemExit(
                        "Error: Filter coverage need a positive number."
                    )
                if lo > up:
                    raise SystemExit(
                        "Error: lower cutoff need be smaller than upper cutoff "
                    )
                opt.coverage_vec.append((lo, up))
    else:
        raise SystemExit(
            "Error: colored run needs -C coverage file or -h histogram list"
        )


def cmd_cutoff_l(argv) -> int:
    from .kmer.cutoffs import cutoff_lower

    if len(argv) != 1:
        print("Usage:ploidyfrost-tpu-torch cutoffL kmer_histogram_file")
        return 1
    print(max(10, cutoff_lower(argv[0])))
    return 0


def cmd_cutoff_u(argv) -> int:
    from .kmer.cutoffs import cutoff_upper

    if len(argv) == 1:
        print(cutoff_upper(argv[0]))
    elif len(argv) == 2:
        y = float(argv[1])
        if y >= 1:
            print("Usage:ploidyfrost-tpu-torch cutoffU kmer_histogram_file (quantile[<1 ,default:0.998])")
            return 1
        print(cutoff_upper(argv[0], y), end="")
    else:
        print("Usage:ploidyfrost-tpu-torch cutoffU kmer_histogram_file (quantile[<1 ,default:0.998])")
        return 1
    return 0


def cmd_model(argv, device="cuda", group=None) -> int:
    from .model.gmm import run_model

    # model subcommand mutates defaults before parsing (src/Main.cpp:638-642)
    opt = Options()
    opt.coverage_lower = 1
    opt.coverage_upper = 9
    opt.frequency = 0
    opt.k = 1000
    opt.delta = 0.01
    parse_options(argv, opt)
    if opt.coverage_lower > opt.coverage_upper or opt.coverage_lower < 1:
        print("Error: gauss range invalid", file=sys.stderr)
        return 1
    if opt.frequency >= 0.5:
        print("Error: frequency cutoff value should < 0.5", file=sys.stderr)
        return 1
    if not opt.colorfile and not opt.graphfile:
        print("ERROR: input a frequency or coverage file")
        return 1
    ploidy = run_model(
        opt.outprefix,
        fre_file=opt.graphfile or None,
        cov_prefix=opt.colorfile or None,
        gauss_lower=opt.coverage_lower,
        gauss_upper=opt.coverage_upper,
        frequency=opt.frequency,
        max_iter=opt.k,
        delta=opt.delta,
        m_threshold=opt.mthreshold,
        n_threshold=opt.nthreshold,
        device=device,
        group=group,
    )
    print(f"estimated ploidy level is : {int(ploidy)}")
    return 0


def cmd_count(argv, device="cuda", group=None) -> int:
    """Native k-mer counting (replaces `kmc -ci1 -cs10000 -k25` +
    `kmc_tools transform histogram`, script/pipeline/2.kmc_db). With a
    group every rank counts its slices and sends its shard to rank 0,
    which alone receives the table, writes it and prints."""
    import numpy as np

    from . import resolve_device
    from .io.fastx import ReadAhead
    from .parallel.mesh import is_primary
    from .pipeline import count_sample

    dev = resolve_device(device)
    opt = parse_options(argv, Options())
    if not opt.inputs:
        print("Error: no input reads", file=sys.stderr)
        return 1
    with ReadAhead([opt.inputs], opt.k) as reader:
        counter = count_sample(reader, 0, dev, group=group)
    if not is_primary(group):
        return 0
    km, ct = counter.arrays()
    counter.write_histogram(opt.outprefix + ".hist.txt")
    np.savez(opt.outprefix + ".kmers.npz", kmers=km, counts=ct, k=opt.k)
    print(
        f"count: {counter.total_kmers} k-mer instances, "
        f"{counter.num_unique} distinct (k={opt.k})"
    )
    return 0


def cmd_build(argv, device="cuda", device_build=False, group=None) -> int:
    from .pipeline import build_colored_graph_cli, build_graph_cli

    opt = parse_options(argv, Options(), extras="c")
    opt.device_build = device_build
    if opt.colored:
        return build_colored_graph_cli(opt, device, group)
    return build_graph_cli(opt, device, group)


def cmd_run(argv, device="cuda", group=None) -> int:
    from .pipeline import run_analysis, run_colored_analysis

    opt = parse_options(argv, Options())
    if not opt.graphfile:
        print("No input file given to load graph!")
        return 1
    if not opt.db:
        print("Error: Need input a kmc database prefix!", file=sys.stderr)
        return 1
    if opt.complex_size < 4:
        print("Error: Maximum number of unitigs in superbubble is at least 4 !", file=sys.stderr)
        return 1
    if opt.nb_threads > 1:
        # pthread data parallelism (src/CDBG.cpp:1726-1777) is replaced by
        # device batching here; the flag stays for CLI compatibility
        print(
            f"note: -t {opt.nb_threads} accepted for compatibility; "
            "the analysis phase is device-batched, not host-threaded"
        )
    if opt.colorfile:
        parse_coverage_vec(opt)
        return run_colored_analysis(opt, device, group)
    if opt.hist:
        from .kmer.cutoffs import cutoff_lower, cutoff_upper

        opt.coverage_lower = max(10, cutoff_lower(opt.hist))
        opt.coverage_upper = cutoff_upper(opt.hist, opt.frequency)
    return run_analysis(opt, device, group)


def _extract_trim(argv):
    """Strip ``--trim[=SPEC]`` from argv; return (argv, TrimConfig|None).

    SPEC is Trimmomatic-style, default = the reference pipeline's
    arguments (script/pipeline/1.trim:16):
    LEADING:10,TRAILING:10,SLIDINGWINDOW:3:20,MINLEN:50.
    """
    from .io.trim import TrimConfig

    out, trim = [], None
    for a in argv:
        if a == "--trim":
            trim = TrimConfig()
        elif a.startswith("--trim="):
            try:
                trim = TrimConfig.parse(a[len("--trim=") :])
            except ValueError as e:
                # friendly CLI error, not a traceback
                raise SystemExit(f"Error: {e}") from None
        else:
            out.append(a)
    return out, trim


def cmd_pipeline(argv, device="cuda", device_build=False, group=None) -> int:
    from .pipeline import run_pipeline_cli

    argv, trim = _extract_trim(argv)
    opt = parse_options(argv, Options(), extras="c")
    opt.trim = trim
    opt.device_build = device_build
    return run_pipeline_cli(opt, device, group)


def cmd_pipeline_multi(argv, device="cuda", device_build=False, group=None) -> int:
    from .pipeline import run_multisample_pipeline_cli

    argv, trim = _extract_trim(argv)
    opt = parse_options(argv, Options(), extras="c")
    opt.trim = trim
    opt.device_build = device_build
    return run_multisample_pipeline_cli(opt, device, group)


def _extract_device(argv):
    """Strip ``--device=cuda|cpu`` from argv; return (argv, device)."""
    out, device = [], "cuda"
    for a in argv:
        if a.startswith("--device="):
            device = a[len("--device=") :]
            if device not in ("cuda", "cpu"):
                raise SystemExit(f"Error: --device must be cuda or cpu, got {device!r}")
        else:
            out.append(a)
    return out, device


# subcommands that run no device work: never split over ranks
_HOST_ONLY = ("cutoffL", "cutoffU", "filter", "filter-multi", "drawfreq")


def main(argv=None) -> int:
    from .parallel.mesh import extract_devices_flag, resolve_mesh, run_ranks

    argv = list(sys.argv[1:] if argv is None else argv)
    argv, device = _extract_device(argv)
    device_build = "--device-build" in argv
    argv = [a for a in argv if a != "--device-build"]
    argv, devspec = extract_devices_flag(argv)
    if not argv:
        print(__doc__)
        return 0
    plan = None if argv[0] in _HOST_ONLY else resolve_mesh(devspec, device)
    if plan is not None:
        return run_ranks(plan, _rank_main, (argv, device_build))
    return _main(argv, device, device_build)


def _rank_main(group, argv, device_build) -> int:
    """One rank of a --devices run (parallel/mesh.run_ranks)."""
    return _main(argv, str(group.device), device_build, group)


def _main(argv, device, device_build, group=None) -> int:
    try:
        return _dispatch(argv, device, device_build, group)
    except ValueError as e:
        if str(e).startswith("Invalid option"):
            # reference behavior: "Invalid option" + usage + clean exit
            # (src/Main.cpp:193-197)
            print("Invalid option")
            print(__doc__)
            return 1
        raise


def _dispatch(argv, device, device_build=False, group=None) -> int:
    cmd = argv[0]
    if cmd == "model":
        return cmd_model(argv[1:], device, group)
    if cmd == "cutoffL":
        return cmd_cutoff_l(argv[1:])
    if cmd == "cutoffU":
        return cmd_cutoff_u(argv[1:])
    if cmd == "count":
        return cmd_count(argv[1:], device, group)
    if cmd == "build":
        return cmd_build(argv[1:], device, device_build, group)
    if cmd == "pipeline":
        return cmd_pipeline(argv[1:], device, device_build, group)
    if cmd == "pipeline-multi":
        return cmd_pipeline_multi(argv[1:], device, device_build, group)
    if cmd == "filter":
        from .filter import cmd_filter

        return cmd_filter(argv[1:], multi=False)
    if cmd == "filter-multi":
        from .filter import cmd_filter

        return cmd_filter(argv[1:], multi=True)
    if cmd == "drawfreq":
        from .filter import cmd_drawfreq

        return cmd_drawfreq(argv[1:])
    if cmd == "figures":
        from .figures import cmd_figures

        return cmd_figures(argv[1:], device, group)
    return cmd_run(argv, device, group)


if __name__ == "__main__":
    raise SystemExit(main())
