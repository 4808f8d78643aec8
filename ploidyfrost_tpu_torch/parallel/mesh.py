# Ported from ploidyfrost_tpu/parallel/mesh.py onto torch.distributed.
"""Device selection for the CLI: `--devices[=N]`, the multi-host
environment, and one process (rank) per device.

The reference's parallelism is `-t <threads>` (src/Main.cpp:124). The
JAX package drives N devices from one process through a Mesh; PyTorch's
idiom is one process per device, so here:

  * `cli.main` resolves the device count: ``--devices=N``, else the
    PLOIDYFROST_DEVICES variable (an int or "auto"), else auto. Auto is
    every visible card when there is more than one, and 1 on
    --device=cpu. ``--devices=1`` is the single-device path.
  * With more than one, `run_ranks` starts one rank per local device
    with the `spawn` start method. Rank r runs on cuda:r with NCCL; with
    --device=cpu every rank runs on the CPU with gloo. The ranks of one
    host meet through a file in a fresh temporary directory, so runs
    side by side never compete for a port.
  * Every rank starts the same subcommand on the same inputs, and the
    ranks split the counter, the superbubble search and the EM
    (parallel/sharded.py). Rank 0 alone, as the JAX package's one
    process on its mesh, receives the count table, builds the graph,
    replays the search, runs the sites pass and writes (`is_primary`);
    the other ranks join only those collectives and the barriers
    (`sync`). An error that only rank 0 can see reaches the others
    through `rank0_decides` before they wait for it. The parent returns
    rank 0's exit code, or a rank's non-zero code as soon as one fails,
    and then stops the others.

Multi-host, with the JAX package's variables:

    PLOIDYFROST_COORDINATOR   host:port of process 0 (the rendezvous,
                              init_method tcp://host:port)
    PLOIDYFROST_NUM_PROCESSES total process count
    PLOIDYFROST_PROCESS_ID    this process's index
    PLOIDYFROST_LOCAL_DEVICES (optional) ranks each process starts: the
                              per-process device count of a CPU drill

Each such process starts one rank per local device, as a JAX process
owns its local devices; global rank = process_id * local + r, and
--devices=N then counts the devices of all processes together.

PLOIDYFROST_TIMEOUT (seconds, default 1800) bounds how long a
collective waits for its peers, so a rank that dies cannot hang the
others for ever.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing
import multiprocessing.connection
import os
import shutil
import sys
import tempfile
import time

import torch

DEFAULT_TIMEOUT_S = 1800.0


@dataclasses.dataclass(frozen=True)
class MultiHost:
    """The multi-host environment (PLOIDYFROST_COORDINATOR and friends)."""

    coordinator: str
    num_processes: int
    process_id: int
    local_devices: int | None


@dataclasses.dataclass(frozen=True)
class RankPlan:
    """How many ranks this process starts and where they meet: `local`
    ranks, global ranks offset .. offset + local - 1 of `world`, on
    `device_type` ("cuda" or "cpu"); `init_method` None means a file in
    a fresh temporary directory."""

    local: int
    world: int
    offset: int
    device_type: str
    init_method: str | None
    timeout_s: float
    threads: int = 1

    @property
    def backend(self) -> str:
        return "nccl" if self.device_type == "cuda" else "gloo"


@dataclasses.dataclass(frozen=True)
class Group:
    """One rank's view of the process group (torch.distributed's default
    group): the counterpart of the JAX package's Mesh handed to the
    sharded stages."""

    rank: int
    world: int
    device: torch.device
    init_s: float = 0.0  # seconds to join the group, communicator set-up included
    # seconds from the start of this rank's process (run_ranks) to its
    # group join; None where the caller joined in a process of its own
    start_s: float | None = None


def extract_devices_flag(argv: list[str]):
    """Strip ``--devices[=N]`` from argv; return (argv, spec)."""
    out: list[str] = []
    spec: int | str | None = None
    for a in argv:
        if a == "--devices":
            spec = "auto"
        elif a.startswith("--devices="):
            v = a[len("--devices=") :]
            try:
                spec = int(v)
            except ValueError:
                raise SystemExit(
                    f"Error: --devices expects an integer, got '{v}'"
                ) from None
            if spec < 1:
                raise SystemExit("Error: --devices must be >= 1")
        else:
            out.append(a)
    return out, spec


def set_mesh_spec(spec: int | str | None) -> int | str:
    """spec: int device count, "auto", or None. None defers to the
    PLOIDYFROST_DEVICES variable (int or "auto"), defaulting to auto —
    so the flag wins, then the environment, then auto-detection. The
    JAX package stores the answer in the module; here it is returned."""
    if spec is None:
        env = os.environ.get("PLOIDYFROST_DEVICES", "auto")
        spec = env if env == "auto" else int(env)
    return spec


def maybe_distributed_init() -> MultiHost | None:
    """The multi-host environment, or None when PLOIDYFROST_COORDINATOR
    is unset (one process). Nothing is initialised here: each rank joins
    the group in `init_group`."""
    coord = os.environ.get("PLOIDYFROST_COORDINATOR")
    if not coord:
        return None
    local = os.environ.get("PLOIDYFROST_LOCAL_DEVICES")
    return MultiHost(
        coordinator=coord,
        num_processes=int(os.environ["PLOIDYFROST_NUM_PROCESSES"]),
        process_id=int(os.environ["PLOIDYFROST_PROCESS_ID"]),
        local_devices=int(local) if local else None,
    )


def resolve_mesh(spec: int | str | None, device: str) -> RankPlan | None:
    """The ranks for this invocation, or None for the single-device
    path. `device` is the CLI's --device ("cuda" or "cpu"). Raises
    SystemExit when more devices are asked for than are visible."""
    spec = set_mesh_spec(spec)
    mh = maybe_distributed_init()
    nproc = mh.num_processes if mh else 1
    if mh and mh.local_devices:
        local_avail = mh.local_devices
    elif device == "cuda":
        local_avail = torch.cuda.device_count()
    else:
        local_avail = os.cpu_count() or 1
    n_avail = nproc * local_avail
    if spec == "auto":
        if device == "cpu" and not (mh and mh.local_devices):
            n = nproc  # one CPU rank a process
        else:
            n = n_avail if n_avail > 1 else 1
    else:
        n = int(spec)
        if n > max(n_avail, 1):  # one device is the single-device path
            raise SystemExit(
                f"Error: --devices={n} but only {n_avail} devices visible"
            )
    if n == 1:
        return None
    if n % nproc:
        raise SystemExit(
            f"Error: --devices={n} is no multiple of "
            f"PLOIDYFROST_NUM_PROCESSES={nproc}"
        )
    local = n // nproc
    timeout = float(os.environ.get("PLOIDYFROST_TIMEOUT", DEFAULT_TIMEOUT_S))
    return RankPlan(
        local=local,
        world=n,
        offset=(mh.process_id if mh else 0) * local,
        device_type=device,
        init_method=f"tcp://{mh.coordinator}" if mh else None,
        timeout_s=timeout,
        # the host's threads split over this process's CPU ranks
        threads=max(1, torch.get_num_threads() // local),
    )


def init_group(plan: RankPlan, local_rank: int) -> Group:
    """Join the process group as global rank plan.offset + local_rank,
    on cuda:local_rank (NCCL) or the CPU (gloo). Returns once every rank
    has joined: the barrier also sets up NCCL's communicator, which the
    first collective of a stage would otherwise pay for."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    if plan.device_type == "cuda":
        torch.cuda.set_device(local_rank)
        device = torch.device("cuda", local_rank)
    else:
        device = torch.device("cpu")
    rank = plan.offset + local_rank
    dist.init_process_group(
        plan.backend,
        init_method=plan.init_method,
        world_size=plan.world,
        rank=rank,
        timeout=datetime.timedelta(seconds=plan.timeout_s),
    )
    group = Group(rank, plan.world, device)
    sync(group)
    return dataclasses.replace(group, init_s=time.perf_counter() - t0)


def is_primary(group: Group | None = None) -> bool:
    """True on the rank that holds the count table and the graph and
    writes every file (rank 0, or always on the single-device path). The
    other ranks hold only their shard and their slices, and join the
    collectives."""
    return group is None or group.rank == 0


def rank0_decides(group: Group | None, rc: int = 0) -> int:
    """Rank 0's return code `rc` on every rank of `group` (one broadcast;
    `rc` itself without a group). Rank 0 alone reads the graph and the
    count databases, so it alone sees that one is missing or does not
    fit: it tells the others here, before they wait for it in the next
    collective, and every rank returns the code at once instead of at
    the group's timeout."""
    if group is None:
        return rc
    import torch.distributed as dist

    t = torch.tensor([rc if group.rank == 0 else 0], dtype=torch.int64, device=group.device)
    dist.broadcast(t, 0)
    return int(t)


@contextlib.contextmanager
def rank0_checks(group: Group | None):
    """Around rank 0's checks of its inputs, which a `rank0_decides`
    ends: an error raised inside (a SystemExit with the reference's
    message, a missing file) first tells the other ranks, as
    rank0_decides(group, 1), and then propagates."""
    try:
        yield
    except (Exception, SystemExit):
        if group is not None:
            rank0_decides(group, 1)
        raise


def sync(group: Group | None) -> None:
    """Wait until every rank of `group` gets here (nothing to wait for
    without one): the files rank 0 wrote before are complete."""
    if group is not None:
        import torch.distributed as dist

        if group.device.type == "cuda":
            dist.barrier(device_ids=[group.device.index])
        else:
            dist.barrier()


def make_counter(k: int, device="cuda", group: Group | None = None, **kw):
    """A KmerCounter (single device) or ShardedKmerCounter (group) with
    the same surface: the pipeline entry points stay group-agnostic."""
    if group is not None:
        from .sharded import ShardedKmerCounter

        return ShardedKmerCounter(group, k, **kw)
    from ..kmer.count import KmerCounter

    return KmerCounter(k, device=device, **kw)


def _rank_entry(plan: RankPlan, local_rank: int, target, args, started: float) -> None:
    """A spawned rank, its process started at wall time `started`: join
    the group, run target(group, *args), exit with its return code. Only
    rank 0 prints to stdout."""
    if plan.device_type == "cpu":
        torch.set_num_threads(plan.threads)
    if plan.offset + local_rank != 0:
        sys.stdout = open(os.devnull, "w")
    group = init_group(plan, local_rank)
    group = dataclasses.replace(group, start_s=time.time() - started)
    rc = target(group, *args)
    import torch.distributed as dist

    dist.destroy_process_group()
    sys.exit(rc)


def run_ranks(plan: RankPlan, target, args=(), timeout: float | None = None) -> int:
    """Start plan.local ranks, each running target(group, *args) (a
    module-level function: it is pickled by name), and wait for them.
    Returns rank 0's exit code when every rank succeeds, else the first
    non-zero code seen, after stopping the ranks still running. With
    `timeout` (seconds), ranks still running then are stopped and the
    result is non-zero."""
    ctx = multiprocessing.get_context("spawn")
    tmp = None
    if plan.init_method is None:
        tmp = tempfile.mkdtemp(prefix="ploidyfrost_rdv_")
        plan = dataclasses.replace(
            plan, init_method="file://" + os.path.join(tmp, "rendezvous")
        )
    procs = []
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for r in range(plan.local):
            procs.append(ctx.Process(target=_rank_entry,
                                     args=(plan, r, target, args, time.time())))
            procs[-1].start()
        while True:
            failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if failed:
                return failed[0]
            running = [p for p in procs if p.exitcode is None]
            if not running:
                return procs[0].exitcode
            wait = 1.0 if deadline is None else max(0.0, deadline - time.monotonic())
            if deadline is not None and wait == 0.0:
                print(f"Error: ranks still running after {timeout} s", file=sys.stderr)
                return 1
            multiprocessing.connection.wait([p.sentinel for p in running], min(wait, 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is None:  # never started
                continue
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
