"""Run one cell of the port's benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up: the cell's reads are made from the seed and written as gzipped
FASTQ under a directory of the run in TMPDIR (one process a file); one
warm-up call on a 100 kb read set of the same shape builds or loads the
port's CUDA and host libraries and makes the CUDA context. `setup_s`
runs from the process's start to the window's start. The window: calls
back to back from one caller for `--seconds`; the call running when
the time is up is finished and counted. A call is the traffic mix's
commands (benchmark/traffic/<traffic>.json) through the port's command
functions in ploidyfrost_tpu_torch/cli.py, as the CLI dispatches them.
With `--trace 1` one more call, right after the warm-up, runs under
torch.profiler (device activity only) and the per-layer metrics are
reported instead of the end-to-end ones.

A cell on several cards runs the port's several-card path instead
(benchmark/ranks.py): one rank a card, started in set-up, every call
on all of them.

After the window the plain reference checks the last call's outputs
(benchmark/check.py). The last line of standard output is the result:
correct, attempted, failed, metrics, device, breakdown (traced runs)
and checks (every compared number with its limit), the same numbers
on the last lines of standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "ploidyfrost_tpu")
COMMANDS = {"pipeline": "cmd_pipeline", "pipeline-multi": "cmd_pipeline_multi"}
WARMUP_GENOME_BP = 100_000


def process_start() -> float:
    """Wall-clock time at which this process started (/proc)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def top_level_modules() -> set[str]:
    return {m.split(".")[0] for m in list(sys.modules)}


def forbidden_modules() -> list[str]:
    return sorted(top_level_modules() & set(FORBIDDEN))


def proc_field(path: str, key: str) -> int | None:
    """The first number after `key` in a /proc file, or None."""
    try:
        with open(path) as f:
            for line in f:
                if line.startswith(key):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def expand(step: dict, cfg: dict, out: str, samples: list[list[str]]) -> tuple[str, list[str]]:
    """(command, argv) of one traffic step for this configuration."""
    several = len(samples) > 1
    cmd = step.get("several_samples", step["command"]) if several else step["command"]
    argv = []
    for a in step["args"]:
        if a == "{samples}":
            argv += [",".join(s) for s in samples] if several else list(samples[0])
        else:
            argv.append(a.replace("{k}", str(cfg["k"])).replace("{out}", out))
    return cmd, argv


class Program:
    """The port under test: its command functions, counters and the
    stage seconds of each call (the `stage_seconds` of the Options each
    command builds). On a rank of a several-card cell (benchmark/ranks.py)
    `group` is the rank's Group, handed to each command as the port's
    cli._rank_main hands it."""

    def __init__(self, device: str, group=None):
        from ploidyfrost_tpu_torch import cli
        from ploidyfrost_tpu_torch.align import batch_nw
        from ploidyfrost_tpu_torch.bubble import batched
        from ploidyfrost_tpu_torch.kmer import extract
        from ploidyfrost_tpu_torch.model import gmm

        self.cli, self.device, self.group = cli, device, group
        self.modules = {"K1": (extract, "LAUNCHES"), "search": (batched, "SEARCH_LAUNCHES"),
                        "EM": (gmm, "EM_LAUNCHES"), "NW": (batch_nw, "NW_LAUNCHES")}
        base = cli.Options
        made = self.made = []

        class Recorded(base):
            def __init__(self):
                super().__init__()
                made.append(self)

        self._recorded = Recorded

    def launches(self) -> dict:
        return {name: int(getattr(mod, attr)) for name, (mod, attr) in self.modules.items()}

    def call(self, steps: list[tuple[str, list[str]]], logfile: str) -> tuple[int, dict, float]:
        """Run one call; returns (exit code, stage seconds, wall s)."""
        del self.made[:]
        base, self.cli.Options = self.cli.Options, self._recorded
        t0 = time.perf_counter()
        rc = 0
        try:
            with open(logfile, "w") as f, contextlib.redirect_stdout(f):
                for cmd, argv in steps:
                    try:
                        rc = getattr(self.cli, COMMANDS[cmd])(list(argv), self.device,
                                                              group=self.group) or 0
                    except (Exception, SystemExit):  # a failed call, counted as such
                        traceback.print_exc(file=f)
                        print(traceback.format_exc(limit=3), file=sys.stderr)
                        rc = 1
                    if rc:
                        break
            if self.device != "cpu":
                import torch

                torch.cuda.synchronize()
        finally:
            self.cli.Options = base
        wall = time.perf_counter() - t0
        stages: dict[str, float] = {}
        for opt in self.made:
            for name, s in opt.stage_seconds.items():
                stages[name] = stages.get(name, 0.0) + float(s)
        return rc, stages, wall


def make_reads(cfg: dict, seed: int, directory: str, processes: int | None):
    from .gen import reads

    reads.sanity(cfg)
    os.makedirs(directory, exist_ok=True)
    return reads.write_all(cfg, seed, directory, processes)


def profiled_call(program: Program, steps, logfile: str) -> dict:
    """One call under torch.profiler (device activity): its device
    events, the K1 launches' shapes and every counter's rise."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ploidyfrost_tpu_torch.kmer import extract

    from . import profiles

    shapes = []
    launch = extract.launch

    def counted(codes, k, dst, count):
        shapes.append((int(codes.shape[0]), int(codes.shape[1]), int(k)))
        return launch(codes, k, dst, count)

    before = program.launches()
    extract.launch = counted
    try:
        acts = [ProfilerActivity.CPU if program.device == "cpu" else ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            rc, stages, wall = program.call(steps, logfile)
    finally:
        extract.launch = launch
    after = program.launches()
    return profiles.summarize(prof, wall, stages, shapes,
                              {n: after[n] - before[n] for n in after}, rc)


def drive(program: Program, cfg: dict, traffic: dict, seed: int, samples, workdir: str,
          seconds: float, trace: bool, after_setup=None) -> dict:
    """The warm-up, the profiled call (traced runs) and the window."""
    import torch

    device = program.device
    t = time.time()
    # the warm-up: the same recipe at 100 kb, through the same call
    small = dict(cfg, genome_bp=min(WARMUP_GENOME_BP, cfg["genome_bp"]))
    wdir = os.path.join(workdir, "warmup_reads")
    make_reads(small, seed, wdir, 1)
    from .gen import reads

    wsamples = reads.mate_paths(small, wdir)
    os.chdir(workdir)
    out = "out"
    wsteps = [expand(s, small, out, wsamples) for s in traffic["call"]]
    rc, _, _ = program.call(wsteps, os.path.join(workdir, "warmup.log"))
    if rc:
        raise RuntimeError(f"warm-up call returned {rc}")
    steps = [expand(s, cfg, out, samples) for s in traffic["call"]]
    d = {"warmup_s": time.time() - t}
    if after_setup is not None:
        after_setup()
    logfile = os.path.join(workdir, "call.log")
    d["prof"] = profiled_call(program, steps, logfile) if trace else None

    gc.collect()
    d["setup_peak"] = 0
    if device != "cpu":
        d["setup_peak"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    d["t_window"] = time.time()
    end = time.perf_counter() + seconds
    calls = failed = 0
    stage_sums: dict[str, float] = {}
    launches0 = program.launches()
    w0 = time.perf_counter()
    while True:
        rc, stages, _ = program.call(steps, logfile)
        calls += 1
        failed += rc != 0
        for name, s in stages.items():
            stage_sums[name] = stage_sums.get(name, 0.0) + s
        if time.perf_counter() >= end:
            break
    d["window_s"] = time.perf_counter() - w0
    d["launches"] = {n: v - launches0[n] for n, v in program.launches().items()}
    d["window_peak"] = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    d["host_peak"] = proc_field("/proc/self/status", "VmHWM:")  # KiB
    d.update(calls=calls, failed=failed, stage_sums=stage_sums)
    with open(logfile) as f:
        d["call_log"] = f.read()
    return d


def run_cell(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, limits: dict, bench: dict, workdir: str,
             processes: int | None = None, after_setup=None) -> dict:
    """Set-up, window, check on one device: the result's fields (without
    printing). `after_setup()`, when given, runs between the set-up and
    the window (the tests break the timed path there)."""
    from .gen import reads

    info: dict = {}
    t = time.time()
    samples, gen_bytes = make_reads(cfg, seed, os.path.join(workdir, "reads"), processes)
    info.update(generate_s=time.time() - t, reads=reads.expected_reads(cfg), gen_bytes=gen_bytes)
    t = time.time()
    program = Program(device)
    info["import_s"] = time.time() - t
    d = drive(program, cfg, traffic, seed, samples, workdir, seconds, trace,
              after_setup=after_setup)
    del program  # the check runs once the program's state is freed
    return finish(cell, cfg, seed, workdir, limits, bench, device, d, info, t_start)


def finish(cell, cfg, seed, workdir, limits, bench, device, d: dict, info: dict,
           t_start: float) -> dict:
    """The check and the result from what `drive` measured."""
    import torch

    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    from . import check

    calls, failed, window_s = d["calls"], d["failed"], d["window_s"]
    info.update(warmup_s=d["warmup_s"], calls=calls,
                stage_sums={n: round(v, 6) for n, v in d["stage_sums"].items()},
                launches=d["launches"], window_s=window_s, host_peak=d["host_peak"])
    t = time.time()
    try:
        res = check.compare(cfg, seed, workdir, "out", d["call_log"], torch.device(device))
    except Exception:  # outputs the reference cannot read: nothing compares
        log(traceback.format_exc())
        res = {n: check.FAILED for n in limits
               if n != "colors_off" or len(cfg["samples"]) > 1}
    info["reference_s"] = time.time() - t
    correct, rows = check.verdict(res, limits)
    info["check_counts"] = {n: v for n, v in res.items() if n.startswith("_")}
    correct &= failed == 0

    prof = d["prof"]
    run = {"calls": calls, "window_s": window_s, "stage_sums": d["stage_sums"], "profile": prof,
           "launches": d["launches"], "samples": len(cfg["samples"])}
    metrics = {}
    unit = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if prof is not None:
        for m in spec.metrics_of(cell["name"], "per_layer", bench):
            value = spec.metric_reader(m["name"]).read(run)
            if value is None:
                info.setdefault("missing", []).append(m["name"])
            else:
                metrics[m["name"]] = {"value": value, "unit": unit[m["name"]]}
    else:
        e2e = {"setup_s": d["t_window"] - t_start, "call_s": window_s / calls,
               "peak_device_GiB": d["window_peak"] / 2**30}
        for m in spec.metrics_of(cell["name"], "end_to_end", bench):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device_info = {"platform": "gpu" if device != "cpu" else "cpu",
                   "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(max(d["setup_peak"], d["window_peak"]))}
    result = {"correct": bool(correct), "attempted": calls, "failed": failed,
              "metrics": metrics, "device": device_info}
    if prof is not None:
        # several cards: the mean over their profiles (benchmark/ranks.py)
        device_info["busy_s"] = d.get("busy_mean_s", prof["busy_s"])
        device_info["window_s"] = prof["wall_s"]
        result["breakdown"] = prof["breakdown"]
    # every compared number beside its limit, last in the line
    result["checks"] = rows
    return {"result": result, "info": info, "prof": prof}


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi."""
    import subprocess

    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return p.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    cfg = spec.config(cell["config"], bench)
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits()
    for m in spec.metrics_of(cell["name"], "per_layer", bench):
        spec.metric_reader(m["name"])  # an unknown reader fails before any work

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"error: the cell asks for {cell['chips']} CUDA device(s), {n} available")
        return 2
    log(f"card: {card_line()}")
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    workdir = tempfile.mkdtemp(prefix="pfbench_", dir=base)
    here = os.getcwd()
    try:
        r = runner(cell)(cell, cfg, traffic, args.seed, args.seconds, bool(args.trace), "cuda",
                         t_start, limits, bench, workdir)
    finally:
        os.chdir(here)
        shutil.rmtree(workdir, ignore_errors=True)
    return report(r)


def runner(cell: dict):
    """`run_cell` for a cell on one card; for one on several, the rank
    path of benchmark/ranks.py (the same arguments and result)."""
    if int(cell["chips"]) == 1:
        return run_cell
    from . import ranks

    return ranks.run_cell


def report(r: dict) -> int:
    """The run's account on standard error and its result as the last
    line of standard output; 3, and no result, where this process or a
    rank loaded a forbidden module."""
    info, result = r["info"], r["result"]
    wchar = proc_field("/proc/self/io", "wchar:")
    to_disk = proc_field("/proc/self/io", "write_bytes:")
    log(f"set-up split: generate {info['generate_s']:.3f} s, imports {info['import_s']:.3f} s, "
        f"warm-up {info['warmup_s']:.3f} s; reads {info['reads']}")
    log(f"bytes written: reads {info['gen_bytes']}; this process {wchar} through write(), "
        f"{to_disk} to storage")
    log(f"window: {info['calls']} calls in {info['window_s']:.3f} s; launches {info['launches']}")
    log("stage seconds summed over the window: " + json.dumps(info["stage_sums"]))
    for line in info.get("rank_log", []):
        log(line)
    log(f"host memory peak of this process (VmHWM, set-up included): {info['host_peak']} KiB")
    if r["prof"] is not None:
        log("profiled call: " + json.dumps({k: v for k, v in r["prof"].items()
                                            if k not in ("breakdown",)}))
    if info.get("missing"):
        log("metrics with nothing to read: " + ", ".join(info["missing"]))
    log(f"reference {info['reference_s']:.3f} s; counts beside the check: "
        + json.dumps(info["check_counts"]))
    bad = {"this process": forbidden_modules()}
    for rank, names in info.get("rank_modules", {}).items():
        bad[f"rank {rank}"] = sorted(set(names) & set(FORBIDDEN))
    if any(bad.values()):
        log("error: loaded in " + "; ".join(f"{where}: {', '.join(names)}"
                                            for where, names in bad.items() if names))
        return 3
    for name, row in result["checks"].items():
        log(f"check {name} {row['value']} limit {row['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
