"""A cell on several cards: the port's several-card path as
`pipeline --devices=N` runs it, driven by one caller.

Set-up starts one rank a card with the port's own launcher
(ploidyfrost_tpu_torch/parallel/mesh.py: `resolve_mesh`, `run_ranks`,
on a thread of the caller), each rank running `serve`, and makes the
reads while they start. The ranks stay up for the whole run: the
warm-up call, the profiled call (traced runs) and every call of the
window run on all of them, each rank calling the same command function
with its Group as the port's cli._rank_main does, and the caller waits
for every rank's reply. Starting the ranks (interpreters, imports, the
rendezvous) falls in `setup_s`; `call_s` is the caller's wall over the
window, as on one card.

What each reading reads on several cards:
  * peak_device_GiB: the largest max_memory_allocated() of the window
    over the ranks, each rank's reset at the window's start;
  * the per-layer seconds: rank 0's stage seconds, summed over the window;
  * the profiled call runs under torch.profiler on every rank, each
    profiling its own card: device_idle_pct, k1_roofline_pct and the
    breakdown read rank 0's card and rank 0's K1 launches; the result's
    device busy_s is the mean of the ranks' busy seconds.
After the window each rank reports the top-level names of its loaded
modules (run.report refuses on a forbidden one), the ranks are stopped,
and only then does the caller touch a card, for the check.

A call that returns non-zero on any rank, a rank that ends, or no reply
in time ends the run with RankFailure once every rank is stopped.
PLOIDYFROST_TIMEOUT (seconds; RANK_TIMEOUT_S when unset) bounds each
collective and the rendezvous, as in the port, and the caller's wait for
a reply to twice that.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import multiprocessing
import multiprocessing.connection
import os
import threading
import time

from . import run

RANK_TIMEOUT_S = 240.0  # PLOIDYFROST_TIMEOUT's value when unset: well inside a run's 360 s
STOP_S = 60.0  # the longest a rank may take to exit once told to stop


class RankFailure(RuntimeError):
    """A rank failed, ended or hung; every rank has been stopped."""


def serve(group, conns, hook=None) -> int:
    """One rank (the target of mesh.run_ranks): run the caller's requests
    from this rank's end of `conns` until told to stop. `hook`
    ("module:function"), when given, is called first with the group: the
    tests plant faults in the ranks with it."""
    conn = conns[group.rank]
    for c in conns:
        if c is not conn:
            c.close()
    os.dup2(2, 1)  # the caller's standard output carries its result alone
    if hook:
        module, name = hook.split(":")
        getattr(importlib.import_module(module), name)(group)
    import torch

    cuda = group.device.type == "cuda"
    program = run.Program(str(group.device), group)
    conn.send({})  # joined
    while True:
        try:
            msg = conn.recv()
        except EOFError:  # the caller is gone
            return 1
        if msg is None:
            return 0
        if msg["kind"] == "call":
            os.chdir(msg["cwd"])
            log = msg["logfile"] if group.rank == 0 else f"{msg['logfile']}.rank{group.rank}"
            if msg["profile"]:
                prof = run.profiled_call(program, msg["steps"], log)
                conn.send({"rc": prof["rc"], "stages": prof["stages"], "prof": prof})
            else:
                rc, stages, _ = program.call(msg["steps"], log)
                conn.send({"rc": rc, "stages": stages})
        else:  # "state"
            if msg["reset_peak"]:
                gc.collect()
            peak = torch.cuda.max_memory_allocated(group.device) if cuda else 0
            if msg["reset_peak"] and cuda:
                torch.cuda.reset_peak_memory_stats(group.device)
            conn.send({"launches": program.launches(), "peak": peak,
                       "modules": sorted(run.top_level_modules()),
                       "host_peak": run.proc_field("/proc/self/status", "VmHWM:")})


class Ranks:
    """The caller's side: the ranks of `plan`, started by mesh.run_ranks
    on a thread of this process, one pipe a rank."""

    def __init__(self, plan, hook: str | None = None):
        from ploidyfrost_tpu_torch.parallel import mesh

        pipes = [multiprocessing.Pipe() for _ in range(plan.local)]
        self.conns = [ours for ours, _ in pipes]
        self._theirs = [theirs for _, theirs in pipes]
        self.timeout_s = plan.timeout_s
        self.rc: int | None = None

        def launch():
            self.rc = mesh.run_ranks(plan, serve, (self._theirs, hook))

        self.thread = threading.Thread(target=launch, name="ranks", daemon=True)
        self.thread.start()

    def ready(self) -> None:
        """Wait until every rank has joined the group."""
        self._replies(self.timeout_s + STOP_S)
        for c in self._theirs:  # every rank holds its own end now
            c.close()

    def call(self, steps, logfile: str, profile: bool = False) -> list[dict]:
        """One call on every rank: each rank's reply, in rank order."""
        self._send({"kind": "call", "steps": steps, "cwd": os.getcwd(), "logfile": logfile,
                    "profile": profile})
        return self._replies(2 * self.timeout_s)

    def state(self, reset_peak: bool) -> list[dict]:
        """Each rank's launch counters, peak device bytes (reset after
        reading with `reset_peak`), top-level modules and VmHWM."""
        self._send({"kind": "state", "reset_peak": reset_peak})
        return self._replies(self.timeout_s)

    def stop(self, kill: bool = False) -> int | None:
        """Tell every rank to stop, or kill them, and wait for the
        launcher: its exit code, None where a rank outlived STOP_S and
        had to be killed."""
        if not kill:
            for c in self.conns:
                try:
                    c.send(None)
                except OSError:
                    pass
            self.thread.join(STOP_S)
        outlived = self.thread.is_alive()
        if outlived:
            # the ranks are this process's only multiprocessing children now:
            # the read generator's pool has ended
            for p in multiprocessing.active_children():
                p.kill()
            self.thread.join(STOP_S)
        for c in self.conns + self._theirs:
            c.close()
        return None if outlived and not kill else self.rc

    def _fail(self, why: str) -> RankFailure:
        self.stop(kill=True)
        return RankFailure(why)

    def _send(self, msg) -> None:
        for i, c in enumerate(self.conns):
            try:
                c.send(msg)
            except OSError as e:
                raise self._fail(f"rank {i} is gone: {e}") from None

    def _replies(self, limit_s: float) -> list[dict]:
        deadline = time.monotonic() + limit_s
        got: dict[int, dict] = {}
        while True:
            pending = [c for i, c in enumerate(self.conns) if i not in got]
            for c in multiprocessing.connection.wait(pending, timeout=1.0):
                i = self.conns.index(c)
                try:
                    got[i] = c.recv()
                except EOFError:
                    raise self._fail(f"rank {i} ended") from None
                if got[i].get("rc"):
                    raise self._fail(f"rank {i}: the call returned {got[i]['rc']}")
            if len(got) == len(self.conns):
                return [got[i] for i in range(len(self.conns))]
            if not self.thread.is_alive():
                raise self._fail(f"the ranks ended, exit code {self.rc}")
            if time.monotonic() > deadline:
                missing = sorted(set(range(len(self.conns))) - set(got))
                raise self._fail(f"no reply from ranks {missing} within {limit_s:.0f} s")


def plan_for(cell: dict, traffic: dict, device: str):
    """The port's RankPlan for the cell's cards (mesh.resolve_mesh). Each
    traffic step carries the `--devices=N` of the command users run, and
    N has to be the cell's cards."""
    from ploidyfrost_tpu_torch.parallel import mesh

    chips = int(cell["chips"])
    for step in traffic["call"]:
        _, devices = mesh.extract_devices_flag(step["args"])
        if devices != chips:
            raise ValueError(f"{cell['name']}: a step of its traffic asks for --devices="
                             f"{devices}, the cell for {chips} cards")
    plan = mesh.resolve_mesh(chips, device)
    return dataclasses.replace(
        plan, timeout_s=float(os.environ.get("PLOIDYFROST_TIMEOUT", RANK_TIMEOUT_S)))


def steps_of(traffic: dict, cfg: dict, out: str, samples) -> list[tuple[str, list[str]]]:
    """The traffic's steps for the ranks: run.expand's, `--devices=N`
    taken out, as cli.main takes it out before it starts the ranks."""
    from ploidyfrost_tpu_torch.parallel import mesh

    steps = [run.expand(s, cfg, out, samples) for s in traffic["call"]]
    return [(cmd, mesh.extract_devices_flag(argv)[0]) for cmd, argv in steps]


def drive(ranks: Ranks, cfg: dict, traffic: dict, seed: int, samples, workdir: str,
          seconds: float, trace: bool) -> dict:
    """The warm-up, the profiled call (traced runs) and the window on
    every rank; what run.finish reads."""
    from .gen import reads

    t = time.time()
    small = dict(cfg, genome_bp=min(run.WARMUP_GENOME_BP, cfg["genome_bp"]))
    wdir = os.path.join(workdir, "warmup_reads")
    run.make_reads(small, seed, wdir, 1)
    os.chdir(workdir)
    out = "out"
    ranks.call(steps_of(traffic, small, out, reads.mate_paths(small, wdir)),
               os.path.join(workdir, "warmup.log"))
    steps = steps_of(traffic, cfg, out, samples)
    d = {"warmup_s": time.time() - t, "prof": None}
    logfile = os.path.join(workdir, "call.log")
    if trace:
        profs = [r["prof"] for r in ranks.call(steps, logfile, profile=True)]
        d["prof"] = profs[0]
        busy = [p["busy_s"] for p in profs]
        d["busy_mean_s"] = sum(busy) / len(busy)

    before = ranks.state(reset_peak=True)
    d["setup_peak"] = max(r["peak"] for r in before)
    d["t_window"] = time.time()
    end = time.perf_counter() + seconds
    calls = 0
    stage_sums: dict[str, float] = {}
    w0 = time.perf_counter()
    while True:
        stages = ranks.call(steps, logfile)[0]["stages"]
        calls += 1
        for name, s in stages.items():
            stage_sums[name] = stage_sums.get(name, 0.0) + s
        if time.perf_counter() >= end:
            break
    d["window_s"] = time.perf_counter() - w0
    after = ranks.state(reset_peak=False)
    launches = [{n: a["launches"][n] - b["launches"][n] for n in a["launches"]}
                for a, b in zip(after, before)]
    d.update(calls=calls, failed=0, stage_sums=stage_sums, launches=launches[0],
             window_peak=max(r["peak"] for r in after),
             host_peak=run.proc_field("/proc/self/status", "VmHWM:"),
             rank_modules={i: r["modules"] for i, r in enumerate(after)})
    d["rank_log"] = [f"rank {i}: launches in the window {launches[i]}; device peak bytes "
                     f"set-up {b['peak']}, window {a['peak']}; host VmHWM {a['host_peak']} KiB"
                     for i, (a, b) in enumerate(zip(after, before))]
    if trace:
        d["rank_log"].append(f"profiled call: device busy s by rank {busy}")
    with open(logfile) as f:
        d["call_log"] = f.read()
    return d


def run_cell(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, limits: dict, bench: dict, workdir: str,
             processes: int | None = None, hook: str | None = None) -> dict:
    """run.run_cell for a cell on several cards: the ranks started, the
    reads made meanwhile, the window on every rank, the ranks stopped,
    then the check (run.finish). `hook` goes to every rank (`serve`)."""
    from .gen import reads

    plan = plan_for(cell, traffic, device)
    info: dict = {}
    t = time.time()
    ranks = Ranks(plan, hook)
    try:
        samples, gen_bytes = run.make_reads(cfg, seed, os.path.join(workdir, "reads"),
                                            processes)
        info.update(generate_s=time.time() - t, reads=reads.expected_reads(cfg),
                    gen_bytes=gen_bytes)
        t = time.time()
        ranks.ready()
        info["import_s"] = time.time() - t  # the ranks' start beyond the reads
        d = drive(ranks, cfg, traffic, seed, samples, workdir, seconds, trace)
    except BaseException:
        ranks.stop(kill=True)
        raise
    rc = ranks.stop()
    if rc != 0:
        raise RankFailure(f"the ranks did not end cleanly: exit code {rc}")
    info["rank_modules"], info["rank_log"] = d.pop("rank_modules"), d.pop("rank_log")
    return run.finish(cell, cfg, seed, workdir, limits, bench, device, d, info, t_start)
