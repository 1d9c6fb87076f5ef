"""The communicator of the multi-device layer, on ``torch.distributed``.

The JAX package runs one controller over a device ``Mesh`` and reduces
with ``lax.psum`` / ``lax.pmax``, exchanging interface planes with
``lax.ppermute``.  ``torch.distributed`` has one process per rank, each
holding only its own shard, so ``Comm`` stands in for the mesh axis:

- ``rank``, ``world_size``;
- ``sum_`` / ``max_``: all-reduce in place (``psum`` / ``pmax``);
- ``shift``: every rank sends a tensor ``step`` ranks on and receives
  the one sent to it (zeros where no rank sends): the neighbour exchange
  of the halo layout (``ppermute`` with the pairs (k, k+1) or (k+1, k));
- ``dot`` / ``norm``: inner products and norms of owner-zero
  distributed vectors (a local product, then one scalar ``sum_``);
- ``bytes`` and ``calls``: the bytes this rank put into each kind of
  collective ("sum", "max", "exchange") and the number of calls, for
  tests and measurements.

A communicator of one rank is the identity and needs no process group.

Backends.  NCCL takes CUDA tensors everywhere but refuses two ranks on one
GPU.  Gloo takes CUDA tensors only for ``all_reduce`` and ``broadcast``;
its point-to-point operations take CPU tensors.  ``default_backend``
picks NCCL where every rank has a GPU of its own, else gloo, and the
exchange stages its planes through host memory exactly when the backend
is gloo (``p2p_device``): one code path for CPU and CUDA tensors,
O(interface) bytes either way.  ``init`` logs which backend runs.

``spawn(fn, nprocs, ...)`` starts ``nprocs`` rank processes (the spawn
start method), joins them into a group on a free local port with a
rendezvous and collective timeout, runs ``fn(comm, *args)`` on each and
returns the ranks' results in rank order.  A rank that raises or dies, a
collective that outlives the timeout, or a call that outlives its
optional ``limit`` fails the whole call, and every rank is killed.
``torchrun`` works as well: ``init()`` reads its environment, and on a
host of several nodes the backend and the device follow the ranks of this
node (LOCAL_WORLD_SIZE, LOCAL_RANK).
"""

from __future__ import annotations

import collections
import datetime
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist


def default_backend(device, world_size: int) -> str:
    """NCCL where the ranks run on CUDA and each can have a GPU of its own,
    else gloo (several ranks on one card, or the CPU).  ``world_size`` is
    the number of ranks on this host (``local_ranks``)."""
    device = torch.device(device)
    if (device.type == "cuda" and dist.is_nccl_available()
            and world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def rank_device(device, rank: int) -> torch.device:
    """The device of a rank: the CPU, or the CUDA device ``rank`` modulo
    the number of GPUs (every rank on ``cuda:0`` on a one-card host).
    ``rank`` is the rank on this host (``local_ranks``)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def local_ranks(rank: int, world_size: int) -> tuple[int, int]:
    """(this rank's index on its host, the number of ranks on its host):
    torchrun's LOCAL_RANK and LOCAL_WORLD_SIZE where it set them, else
    ``rank`` and ``world_size`` (every rank on one host)."""
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world_size)))


class Comm:
    """One rank's view of a process group (or of a single process).

    Args:
        group: the ``torch.distributed`` group (None: the default group,
            or no group at all when ``torch.distributed`` is not
            initialised, which makes a one-rank identity communicator).
        device: this rank's compute device.
        backend: the group's backend ("gloo" or "nccl").
    """

    def __init__(self, group=None, device="cuda", backend: str | None = None):
        self.device = torch.device(device)
        self.group = group
        if dist.is_available() and dist.is_initialized():
            self.rank = dist.get_rank(group)
            self.world_size = dist.get_world_size(group)
            self.ranks = (list(range(self.world_size)) if group is None
                          else dist.get_process_group_ranks(group))
            self.backend = backend or dist.get_backend(group)
        else:
            self.rank, self.world_size, self.ranks = 0, 1, [0]
            self.backend = backend
        # the exchange's staging device: gloo's send/recv take CPU tensors
        self.p2p_device = (torch.device("cpu") if self.backend == "gloo"
                           else None)
        self.bytes = collections.Counter()
        self.calls = collections.Counter()

    def subgroup(self, ranks):
        """A communicator on the ranks ``ranks`` (group ranks of this one):
        every rank of this group must call it; the others get None."""
        glob = [self.ranks[r] for r in ranks]
        g = dist.new_group(glob, backend=self.backend)
        return (Comm(g, self.device, self.backend)
                if self.ranks[self.rank] in glob else None)

    def reset(self):
        """Zero the counters."""
        self.bytes.clear()
        self.calls.clear()

    def _count(self, kind: str, t: torch.Tensor):
        self.bytes[kind] += t.numel() * t.element_size()
        self.calls[kind] += 1

    # -- collectives -------------------------------------------------------
    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce ``t`` in place by sum over the ranks and return it
        (the identity on one rank)."""
        if self.world_size > 1:
            self._count("sum", t)
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce ``t`` in place by maximum and return it."""
        if self.world_size > 1:
            self._count("max", t)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def shift(self, t: torch.Tensor, step: int) -> torch.Tensor:
        """Send ``t`` to rank ``rank + step`` and return what rank ``rank -
        step`` sent here: zeros of ``t``'s shape where no rank sends (the
        JAX package's ``ppermute`` with the pairs (k, k + step))."""
        K, r = self.world_size, self.rank
        dst, src = r + step, r - step
        if K == 1 or not (0 <= src < K or 0 <= dst < K):
            return torch.zeros_like(t)
        stage = t.contiguous()
        if self.p2p_device is not None:
            stage = stage.to(self.p2p_device)
        ops = []
        if 0 <= dst < K:
            self._count("exchange", stage)
            ops.append(dist.P2POp(dist.isend, stage, self.ranks[dst],
                                  self.group))
        recv = None
        if 0 <= src < K:
            recv = torch.empty_like(stage)
            ops.append(dist.P2POp(dist.irecv, recv, self.ranks[src],
                                  self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if recv is None:
            return torch.zeros_like(t)
        return recv.to(t.device)

    def barrier(self):
        if self.world_size > 1:
            dist.barrier(group=self.group)

    # -- owner-zero vectors ---------------------------------------------
    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks of ``a @ b``: the inner product of two
        owner-zero distributed vectors (each dof lives on one rank, ghosts
        hold zero), or with a matrix ``a`` its rows' products (GMRES's
        Gram-Schmidt)."""
        return self.sum_(a @ b)

    def norm(self, a: torch.Tensor) -> torch.Tensor:
        """The 2-norm of an owner-zero distributed vector."""
        return torch.sqrt(self.dot(a, a))


def world(device="cuda") -> Comm:
    """The communicator of the default group, or of this process alone
    where ``torch.distributed`` is not initialised."""
    return Comm(None, device)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(backend: str | None = None, device="cuda", rank: int | None = None,
         world_size: int | None = None, init_method: str | None = None,
         timeout: float = 120.0) -> Comm:
    """Join the default process group and return this rank's ``Comm``.

    Without ``rank`` and ``world_size`` the ``torchrun`` environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT) gives them, through ``env://``;
    a process outside both is a one-rank run (no group).  ``backend``
    None takes ``default_backend``; ``timeout`` (seconds) bounds the
    rendezvous and every collective, not the run.  Rank 0 prints the
    backend."""
    if rank is None:
        if "WORLD_SIZE" not in os.environ:
            dev = rank_device(device, 0)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            return Comm(None, dev)
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    local_rank, local_size = local_ranks(rank, world_size)
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or default_backend(device, local_size)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    comm = Comm(None, dev, backend)
    if rank == 0:
        print(f"comm: {world_size} ranks, backend {backend}, device "
              f"{dev}", flush=True)
    return comm


def _rank_main(rank, nprocs, port, device, timeout, fn, args, results):
    # one torch thread per rank: the ranks share the host's cores
    torch.set_num_threads(1)
    try:
        comm = init(None, device, rank, nprocs, f"tcp://127.0.0.1:{port}",
                    timeout)
        out = fn(comm, *args)
        results.put((rank, True, out))
    except BaseException:  # reported, re-raised; the parent kills the rest
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs: int, args=(), *, device="cuda", timeout: float = 120.0,
          limit: float | None = None):
    """Run ``fn(comm, *args)`` on ``nprocs`` fresh rank processes and return
    their results, rank 0 first.

    ``fn`` and ``args`` must pickle (a module-level function); each rank
    gets its ``Comm`` on ``device`` (see ``rank_device``) over
    ``default_backend``, and one torch CPU thread.
    ``timeout`` (seconds) bounds the rendezvous and every collective;
    ``limit`` (seconds, None: none) bounds the whole call.  A rank that
    raises or dies, or a call that outlives ``limit``, kills every rank
    and raises ``RuntimeError`` (with the rank's traceback) or
    ``TimeoutError``."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [
        ctx.Process(target=_rank_main, args=(
            r, nprocs, port, device, timeout, fn, args, results),
            daemon=True)
        for r in range(nprocs)
    ]
    for p in procs:
        p.start()
    out = {}
    deadline = None if limit is None else time.monotonic() + limit
    try:
        while len(out) < nprocs:
            try:
                rank, ok, val = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} before returning")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{nprocs} ranks did not finish within {limit} s "
                        f"({len(out)} returned)")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return [out[r] for r in range(nprocs)]
