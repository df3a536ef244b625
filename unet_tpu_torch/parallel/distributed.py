"""Multi-process training on `torch.distributed` (port of
unet_tpu/parallel/distributed.py).

The JAX package runs one process per host, which owns all of the host's
chips.  The port runs one process per device, PyTorch's idiom: a rank owns
one card (or, on the CPU, one process), and N ranks train as one device
with N times the batch (`parallel/mesh.py`).

* `initialize` joins the rendezvous at `host:port` (`tcp://`, rank 0 hosts
  it) over NCCL for a CUDA device and gloo for the CPU: a CUDA device gets
  gloo only where the caller names that backend (for ranks that share one
  card, which NCCL refuses), and the CPU never NCCL.  For NCCL
  the rank's card is set first and given to the process group, and one
  collective runs at once, outside any capture, so that the communicator
  exists before a step is captured; `subgroup` does the same for the
  groups of a mesh's axes.  Every rendezvous and every collective waits at
  most `timeout_s`.
* `global_batch` says which rows of the global batch, and of a step's
  draws made for the global batch, a rank owns: rows rank, rank + N, ...,
  which is exactly what a loader's shard `perm[rank::N]` reads
  (`data/dataset.py`), so N ranks at batch B see the batches, timesteps
  and noise of one process at batch N * B.
* `replicate` gathers vectors sharded over the ranks into whole host
  copies for a checkpoint, one vector at a time; every rank joins it.
* `launch` turns one command into N ranks on this machine: N processes of
  the same command, with the rendezvous on a free localhost port in their
  environment (`LAUNCH_ENV`, read back by `launched`).
"""

from __future__ import annotations

import contextlib
import ctypes
import datetime
import os
import pathlib
import signal
import socket
import subprocess
import sys
import tempfile
import time
import warnings
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# The rendezvous of a rank started by `launch`:
# "host:port,world,rank,launcher's pid".
LAUNCH_ENV = "UNET_TPU_TORCH_LAUNCH"
# Longest wait of a rendezvous or a collective, in seconds.
TIMEOUT_S = 600.0
# The launcher: how long the other ranks may run on once one has exited 0,
# how often a rendezvous whose port was taken is tried again, and how often
# the ranks are polled (seconds).
GRACE_S, TRIES, POLL_S = 120.0, 3, 0.1
_ROOT = pathlib.Path(__file__).resolve().parents[2]
# The device `initialize` gave this process (None outside a process group),
# as the process group itself is this process's.
_device: Optional[torch.device] = None


def backend(device) -> str:
    """The process group's backend for a device: NCCL for a CUDA device,
    gloo for the CPU; any other device raises."""
    device = torch.device(device)
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def _rank_device(device, process_id: int) -> torch.device:
    """The device a rank trains on: `device` itself, or for a CUDA device
    without an index, card `process_id` modulo the cards this machine
    shows."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", process_id % torch.cuda.device_count())
    return device


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device="cuda",
               timeout_s: float = TIMEOUT_S,
               process_backend: Optional[str] = None) -> torch.device:
    """Join the rendezvous at `coordinator_address` (host:port; the rank
    with process_id 0 hosts it) as rank `process_id` of `num_processes`,
    and return the rank's device (`device`, or for a CUDA device without
    an index card `process_id` modulo the cards this machine shows).  The
    process group's backend is `backend(device)` unless `process_backend`
    names one: gloo on a CUDA device lets ranks share a card (gloo moves
    CUDA tensors through the host), which only a harness on a one-card
    machine asks for.  A failed rendezvous raises."""
    global _device
    device = _rank_device(device, process_id)
    kind = process_backend or backend(device)
    extra = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if kind == "nccl":
        extra["device_id"] = device
    elif device.type == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        # the ranks of one machine share its cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // num_processes))
    dist.init_process_group(
        kind, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s), **extra)
    _device = device
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    if probe.item() != num_processes:
        raise RuntimeError(f"rendezvous at {coordinator_address}: the first "
                           f"all-reduce gave {probe.item()}, not "
                           f"{num_processes}")
    return device


def shutdown() -> None:
    """Leave the process group `initialize` joined (nothing if none)."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def device() -> torch.device:
    """The device this rank joined the process group with (`initialize`)."""
    if not dist.is_initialized() or _device is None:
        raise RuntimeError("no process group: call "
                           "parallel.distributed.initialize first")
    return _device


def subgroup(partition: Sequence[Sequence[int]],
             timeout_s: float = TIMEOUT_S):
    """The process group of this rank's part of `partition` (lists of
    ranks, each rank in one).  Every rank creates every part's group, in
    the order given, as `dist.new_group` asks, and runs one all-reduce on
    its own, outside any capture, so that its communicator exists before a
    step is captured.  A partition of one part is the default group
    (None): no group is created."""
    if len(partition) == 1:
        return None
    rank = world()[0]
    mine = size = None
    for ranks in partition:
        group = dist.new_group(list(ranks),
                               timeout=datetime.timedelta(seconds=timeout_s))
        if rank in ranks:
            mine, size = group, len(ranks)
    probe = torch.ones(1, device=device())
    dist.all_reduce(probe, group=mine)
    if probe.item() != size:
        raise RuntimeError(f"the first all-reduce of a group of {size} "
                           f"ranks gave {probe.item()}")
    return mine


def world() -> Tuple[int, int]:
    """(rank, number of ranks); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_main() -> bool:
    """True on the rank that owns logging and checkpoint writes."""
    return world()[0] == 0


def global_batch(rank: int, world_size: int) -> slice:
    """The rows of a global batch that rank `rank` of `world_size` owns:
    rank, rank + world_size, ...  A loader's shard `rank` of
    `world_size` reads these rows of what one process reads at the global
    batch, and a step's draws for the global batch are cut to them."""
    return slice(rank, None, world_size)


def all_gather(out: torch.Tensor, piece: torch.Tensor, group=None) -> None:
    """`out` <- every rank's `piece`, in rank order (`piece` may be this
    rank's part of `out` itself), over `group` (None: every rank)."""
    with warnings.catch_warnings():
        # deprecated in newer torch for a name older ones lack
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, piece, group=group)


def reduce_scatter(out: torch.Tensor, whole: torch.Tensor,
                   group=None) -> None:
    """`out` <- this rank's piece of the sum over the ranks of `group`
    (None: every rank) of `whole`."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, whole, group=group)


def replicate(vectors: Sequence[Optional[torch.Tensor]], size: int,
              sharded: bool, group=None) -> List[Optional[torch.Tensor]]:
    """Whole host (CPU) copies of the first `size` elements of vectors
    that are either whole on every rank of `group` (None: every rank;
    `sharded` False) or split evenly over them, each holding its piece.  A
    collective when sharded: every rank of the group calls it, with the
    same vectors in the same order.  One vector at a time, so that the
    device holds at most one whole vector more than the rank's pieces (None
    stays None)."""
    out = []
    for vec in vectors:
        if vec is None:
            out.append(None)
            continue
        if not sharded:
            out.append(vec.detach()[:size].cpu())
            continue
        whole = torch.empty(vec.numel() * dist.get_world_size(group),
                            dtype=vec.dtype, device=vec.device)
        all_gather(whole, vec.detach(), group)
        out.append(whole[:size].cpu())
        del whole
    return out


def broadcast_int(value: int) -> int:
    """Rank 0's `value` on every rank."""
    t = torch.tensor([value], dtype=torch.int64, device=device())
    dist.broadcast(t, src=0)
    return int(t.item())


def any_rank(flag: bool) -> bool:
    """True on every rank if `flag` is true on any rank."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


# --- one command, N ranks ----------------------------------------------------


def launched() -> Optional[Tuple[str, int, int]]:
    """(address, world, rank) of a rank `launch` started, else None.  In
    such a rank it also arranges that the rank dies with the launcher
    (SIGKILL, PR_SET_PDEATHSIG), and exits if the launcher is gone
    already."""
    value = os.environ.get(LAUNCH_ENV)
    if not value:
        return None
    address, world_size, rank, launcher = value.split(",")
    _die_with_parent(int(launcher))
    return address, int(world_size), int(rank)


def free_port() -> int:
    """A localhost port nothing listens on now (another process may take
    it before the rendezvous does: `launch` then tries again)."""
    with contextlib.closing(socket.socket()) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _die_with_parent(parent: int) -> None:
    """SIGKILL to this process when its parent, `parent`, dies."""
    libc = ctypes.CDLL("libc.so.6", use_errno=True)
    PR_SET_PDEATHSIG = 1
    if libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != parent:  # it died before the call above
        raise SystemExit(f"the launcher (pid {parent}) is gone")


_PORT_TAKEN = ("Address already in use", "EADDRINUSE")


class LaunchError(SystemExit):
    """A rank of a launch failed (the exit status of the launcher)."""


def launch(command: Sequence[str], world_size: int) -> None:
    """Run `command` (a program and its arguments) as ranks 0 ..
    world_size - 1 of one process group on this machine, and wait for
    them; each finds its rank in its environment (`launched`).

    Each rank's output goes to a file; rank 0's is copied to this
    process's standard output as it comes.  If a rank exits non-zero, the
    others are killed and `LaunchError` (a `SystemExit`, non-zero) is
    raised with that rank's output; a rendezvous that found its port taken
    is tried again on another (`TRIES` in all).  Once a rank has exited 0,
    the others get `GRACE_S` seconds to follow.  SIGTERM or SIGINT to this
    process is passed on once to every rank (a second one kills them); a
    rank that calls `launched` dies with this process."""
    for attempt in range(TRIES):
        failure = _run_ranks(command, world_size)
        if failure is None:
            return
        rank, code, output = failure
        if attempt + 1 < TRIES and any(s in output for s in _PORT_TAKEN):
            continue
        sys.stderr.write(f"--- output of rank {rank} ---\n{output}\n")
        raise LaunchError(f"launch: rank {rank} of {world_size} failed "
                          f"({code}); the other ranks were stopped")


def _run_ranks(command, world_size):
    """One launch; None when every rank exited 0, else (rank, what went
    wrong, its output)."""
    address = f"localhost:{free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p])
    procs, files = [], []
    signalled = []

    def forward(signum, frame):
        if signalled:  # the second signal: no more grace
            for p in procs:
                p.kill()
            return
        signalled.append(signum)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    previous = {s: signal.signal(s, forward)
                for s in (signal.SIGTERM, signal.SIGINT)}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for rank in range(world_size):
                files.append(os.path.join(tmp, f"rank{rank}.log"))
                env[LAUNCH_ENV] = (f"{address},{world_size},{rank},"
                                   f"{os.getpid()}")
                with open(files[-1], "wb") as f:
                    procs.append(subprocess.Popen(
                        list(command), env=dict(env), stdout=f,
                        stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
                        start_new_session=True))
            return _wait(procs, files)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait(timeout=30)
            for s, handler in previous.items():
                if handler is not None:
                    signal.signal(s, handler)


def _read(path: str) -> str:
    with open(path, "rb") as f:
        return f.read().decode(errors="replace")


def _wait(procs, files):
    shown = 0
    first_done = None

    def relay():
        nonlocal shown
        with open(files[0], "rb") as f:
            f.seek(shown)
            chunk = f.read()
        if chunk:
            shown += len(chunk)
            sys.stdout.write(chunk.decode(errors="replace"))
            sys.stdout.flush()

    while True:
        relay()
        codes = [p.poll() for p in procs]
        for rank, code in enumerate(codes):
            if code not in (None, 0):
                relay()
                return rank, f"exit status {code}", _read(files[rank])
        if all(code == 0 for code in codes):
            relay()
            return None
        if any(code == 0 for code in codes):
            first_done = first_done or time.monotonic()
            if time.monotonic() - first_done > GRACE_S:
                rank = codes.index(None)
                return (rank, f"still running {GRACE_S:g} s after another "
                        "rank finished", _read(files[rank]))
        time.sleep(POLL_S)
