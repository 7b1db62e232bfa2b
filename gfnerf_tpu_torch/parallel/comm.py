"""The collectives of the multi-card paths, over ``torch.distributed``.

Every collective the port runs goes through :class:`Comm`, so that the two
backends differ here alone:

- NCCL (one card per rank) gathers with ``all_gather_into_tensor``;
- gloo (ranks that share a card, and the CPU) supports only ``broadcast``
  and ``all_reduce`` on CUDA tensors, so a gather is the all-reduce of a
  zero-padded buffer whose slot each rank alone writes (the sum is exact).

A group of size 1 runs no collective.  Every collective waits at most the
group's timeout (``init_process_group``'s and ``new_group``'s), so a lost
rank fails the run instead of hanging it.  Collectives replayed from a CUDA
graph escape the process group's watchdog: :func:`wait_bounded` holds the
host's wait for them to the same timeout.  Such a graph is dropped before
the group is destroyed (:func:`before_shutdown`); after a wait that timed
out, :func:`shutdown` aborts the communicators instead, since the replayed
kernels still wait on the card for the lost rank.
"""

from __future__ import annotations

import datetime
import os
import time
import weakref
from typing import Optional, Sequence

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
_BACKENDS = ("nccl", "gloo")

# the world group of this process, once initialize_multihost() has run
_WORLD: Optional["Comm"] = None
# weak references to what shutdown() calls before it destroys the group
_BEFORE_SHUTDOWN: list = []
# what wait_bounded gave up on: shutdown() aborts the communicators then
_TIMED_OUT: list = []


class Comm:
    """One process group: its ranks (global ranks, in the group's order),
    this process's index among them (``rank``) and the backend."""

    def __init__(self, ranks: Sequence[int], group, backend: str,
                 timeout: datetime.timedelta, n_hosts: int = 1):
        self.ranks = list(ranks)
        self.group = group
        self.backend = backend
        self.timeout = timeout
        self.size = len(self.ranks)
        self.rank = self.ranks.index(dist.get_rank())
        self.n_hosts = n_hosts

    @property
    def device(self) -> torch.device:
        """Where this group's own buffers live: the current card under
        NCCL, else the CPU."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def _on_card(self, t: torch.Tensor) -> None:
        if self.backend == "nccl" and not t.is_cuda:
            raise ValueError("NCCL collectives take CUDA tensors")

    def new_group(self, ranks: Sequence[int]) -> "Comm":
        """A sub-group of these ranks.  Every rank of this group calls it,
        with the same ranks, in the same order, whether a member or not;
        a non-member gets None."""
        ranks = [int(r) for r in ranks]
        group = dist.new_group(ranks, timeout=self.timeout,
                               backend=self.backend)
        if dist.get_rank() not in ranks:
            return None
        return Comm(ranks, group, self.backend, self.timeout, self.n_hosts)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the group, in place; returned."""
        if self.size > 1:
            self._on_card(t)
            dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes), concatenated along dim 0 in
        the group's order."""
        if self.size == 1:
            return t
        self._on_card(t)
        t = t.contiguous()
        n = t.shape[0]
        shape = (self.size * n, *t.shape[1:])
        if self.backend == "nccl":
            out = t.new_empty(shape)
            dist.all_gather_into_tensor(out, t, group=self.group)
            return out
        out = t.new_zeros(shape)
        out[self.rank * n:(self.rank + 1) * n] = t
        return self.all_reduce(out)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` overwritten, in place, by the group's rank ``src``'s."""
        if self.size > 1:
            self._on_card(t)
            dist.broadcast(t, src=self.ranks[src], group=self.group)
        return t

    def broadcast_object(self, obj, src: int = 0):
        """The group's rank ``src``'s ``obj`` (pickled), on every rank."""
        if self.size == 1:
            return obj
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(
            box, src=self.ranks[src], group=self.group,
            device=self.device if self.backend == "nccl" else None)
        return box[0]

    def barrier(self) -> None:
        """Wait for every rank of the group (an all-reduce, which the
        group's timeout bounds under either backend)."""
        self.all_reduce(torch.zeros(1, device=self.device))


# seconds between two polls of wait_bounded's event
POLL_S = 1e-4


def wait_bounded(event, comm: Comm, what: str) -> None:
    """Wait until ``event`` (a ``torch.cuda.Event`` recorded after work
    that holds ``comm``'s collectives, or anything with ``query()``) has
    completed, polling it for at most the group's timeout: the process
    group's watchdog does not time collectives replayed from a CUDA graph,
    so a lost rank would otherwise hang the host's next copy for good.
    Raises TimeoutError naming ``what``, the group's ranks and the
    timeout; :func:`shutdown` then aborts the communicators."""
    limit = comm.timeout.total_seconds()
    start = time.monotonic()
    while not event.query():
        if time.monotonic() - start > limit:
            _TIMED_OUT.append(what)
            raise TimeoutError(
                f"{what}: not done after the group's timeout of {limit:g} s;"
                f" a rank of {list(comm.ranks)} did not take part in its "
                "collectives")
        time.sleep(POLL_S)


def world() -> Optional[Comm]:
    """The world group :func:`initialize_multihost` set up, if it has more
    than one
    rank; else None (one process: the one-card code paths)."""
    if _WORLD is None or _WORLD.size == 1:
        return None
    return _WORLD


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None, backend: str = "gloo",
                         timeout_s: float = 600.0,
                         n_hosts: Optional[int] = None,
                         device: str = "cpu") -> Comm:
    """``init_process_group`` with a timeout, and the world :class:`Comm`
    (the counterpart of the JAX package's ``initialize_multihost``).

    Arguments left None are read as ``torch.distributed.run`` sets them:
    ``WORLD_SIZE``, ``RANK`` and the ``env://`` rendezvous
    (``MASTER_ADDR``/``MASTER_PORT``).  ``n_hosts`` (the machines the ranks
    span, host-major) defaults to ``WORLD_SIZE / LOCAL_WORLD_SIZE``, or 1.
    With ``device`` "cuda" the rank takes card ``LOCAL_RANK %
    device_count`` first.  NCCL needs a card per rank: it raises when more
    ranks share this host than it has cards.  A failed rendezvous raises;
    nothing falls back."""
    global _WORLD
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(env.get("RANK", "0"))
    local_world = int(env.get("LOCAL_WORLD_SIZE", "0")) or None
    if n_hosts is None:
        n_hosts = world_size // local_world if local_world else 1
    if backend not in _BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {_BACKENDS}")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        per_host = local_world or -(-world_size // n_hosts)
        if per_host > cards:
            raise RuntimeError(
                f"NCCL needs a card per rank: {per_host} ranks on a host "
                f"with {cards} card(s); pass the gloo backend to share one")
    if device == "cuda":
        local = int(env.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    _WORLD = Comm(range(world_size), None, backend, timeout, n_hosts)
    return _WORLD


def before_shutdown(fn) -> None:
    """Have :func:`shutdown` call ``fn()`` before it destroys the process
    group, if ``fn`` is alive then (it is held weakly): a CUDA graph that
    holds a communicator's collectives is dropped this way before the
    communicator goes."""
    _BEFORE_SHUTDOWN.append(weakref.ref(fn))


def shutdown() -> None:
    """Leave the process group (a no-op without one), after the calls
    :func:`before_shutdown` registered.  After a :func:`wait_bounded` that
    timed out under NCCL, abort every communicator instead: its replayed
    kernels still wait on the card for the lost rank, so neither dropping
    their graph nor a synchronize nor a graceful destroy would return, and
    the abort ends them."""
    global _WORLD
    if _TIMED_OUT and _WORLD is not None and _WORLD.backend == "nccl":
        _BEFORE_SHUTDOWN.clear()
        _TIMED_OUT.clear()
        if dist.is_initialized():
            dist.distributed_c10d._abort_process_group()
        _WORLD = None
        return
    _TIMED_OUT.clear()
    for ref in _BEFORE_SHUTDOWN:
        fn = ref()
        if fn is not None:
            fn()
    _BEFORE_SHUTDOWN.clear()
    if dist.is_initialized():
        if _WORLD is not None and _WORLD.backend == "nccl":
            torch.cuda.synchronize()   # no dropped graph's replay runs on
        dist.destroy_process_group()
    _WORLD = None
