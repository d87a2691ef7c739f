"""Ranks, the data mesh and its collectives on ``torch.distributed``
(``cmlpl_tpu/core/mesh.py``).

The JAX package runs one process over all its chips and shards a step's
batch over the mesh's "data" axis; GSPMD then computes the SAME global
program as one device would: the pseudo-label graph over the whole batch,
the queue writes of the whole batch in its order, the global means and
the gradient's sum over devices.  The port runs one process a card
(``torchrun``, NCCL between cards; gloo on the CPU) and keeps that
semantics by hand, with no DDP and no rank-local loss:

- a step's forwards are the only sharded work.  Each module call takes
  batch-leading inputs; a rank runs its contiguous rows of them
  (:func:`shard_rows`) and the outputs are gathered back into global
  order (:func:`all_gather_rows`), so every rank computes the same losses,
  queue writes and metrics from the same tensors;
- the gather's backward is the rank's rows of the (replicated) output
  gradient, not a sum over ranks: summed, every rank would count each
  rank's rows.  A rank's parameter gradients are then its rows' share,
  and ONE ``all_reduce(SUM)`` of them all (:func:`all_reduce_grads`)
  gives every rank the global gradient;
- a sharded call whose input needs a gradient (CCT's heads on the
  gathered encoder features) completes that gradient over the ranks in
  its backward, so every gradient that reaches a replicated tensor is the
  whole one;
- the random draws are global: every rank holds the same generator
  (:func:`place_state` broadcasts rank 0's) and draws the whole batch's
  views, then takes its rows;
- a layer that reads the whole batch inside a sharded call (a
  train-mode BatchNorm, a dropout that draws its own mask) learns its
  rank's rows of the global batch from :func:`batch_shard`, which the
  sharded call sets (:func:`sharded_batch`): BatchNorm then normalises by
  the global batch's statistics, summed over the ranks by
  :func:`all_reduce_sum`, whose backward sums the ranks' gradients too,
  and dropout draws the global batch's mask and keeps its rows.

The gather is an ``all_reduce(SUM)`` of a zero-filled global buffer into
which each rank writes its rows: ``x + 0 = x`` exactly, and besides
``broadcast`` it is the one collective that gloo takes on CUDA tensors.
A ring ``all_reduce`` hands every rank the same bits, so the replicated
Adams, queues, bank and generators stay bitwise equal across ranks.

A single process (no ``torchrun`` environment) has a :class:`Mesh` of one
rank with no process group, and every function here is then the
identity.  The ("data", "model") mesh of ``create_mesh_2d`` is not ported
(ROADMAP item 10b).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch
import torch.distributed as dist

from cmlpl_tpu_torch.device import resolve_device


def initialize_multihost(backend: str | None = None, device=None) -> int:
    """Join the world that ``torchrun``'s environment describes
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``;
    ``LOCAL_RANK`` picks the card) before any mesh is made; returns the
    number of processes.

    A single process (no ``MASTER_ADDR`` and ``WORLD_SIZE`` at most 1) is a
    no-op that returns 1, so one command line serves one card and many;
    a second call returns the world's size (idempotent).  ``backend``
    defaults to NCCL for a CUDA ``device`` (default: the rank's card) and
    gloo for the CPU; no other backend is tried when it fails."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if "MASTER_ADDR" not in os.environ and world <= 1:
        return 1
    if dist.is_initialized():
        return dist.get_world_size()
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=int(os.environ["RANK"]))
    return dist.get_world_size()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 1-D data mesh: this process's ``rank`` of ``size``, its
    ``device``, and the default group's ``backend`` (None: one process
    and no group, where nothing is communicated)."""
    rank: int
    size: int
    device: torch.device
    backend: str | None = None

    def rows(self, n: int) -> tuple:
        """(lo, hi): this rank's contiguous share of ``n`` rows, the
        rank-th of ``size`` equal blocks (``P("data")`` of JAX)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not divide over {self.size} "
                             "ranks")
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k


def create_mesh(device=None) -> Mesh:
    """The mesh of the default process group (one rank, no group, when
    none was initialised) on ``device`` (default: the rank's card)."""
    device = resolve_device(device)
    if not dist.is_initialized():
        return Mesh(0, 1, device)
    return Mesh(dist.get_rank(), dist.get_world_size(), device,
                dist.get_backend())


def is_distributed(mesh: Mesh | None) -> bool:
    """True when ``mesh`` has a process group (a world of one rank too),
    so its collectives run."""
    return mesh is not None and mesh.backend is not None


def is_multiprocess(mesh: Mesh | None) -> bool:
    """True when ``mesh`` spans more than one process."""
    return mesh is not None and mesh.size > 1


def is_primary(mesh: Mesh | None = None) -> bool:
    """True on the process that writes files: rank 0, or a single
    process."""
    if mesh is not None:
        return mesh.rank == 0
    return not dist.is_initialized() or dist.get_rank() == 0


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n``."""
    return -(-n // m) * m


def gather_rows(x: torch.Tensor, mesh: Mesh, lo: int,
                total: int) -> torch.Tensor:
    """The (total, ...) tensor whose rows ``lo:lo + len(x)`` are this
    rank's ``x`` and whose other rows are the other ranks': an
    ``all_reduce(SUM)`` of a zero-filled buffer, exact (``x + 0 = x``).
    Floats narrower than f32 go through f32 (exact both ways).  Not
    differentiable: see :func:`all_gather_rows`."""
    if not is_distributed(mesh):
        return x
    wide = x.dtype in (torch.bfloat16, torch.float16)
    buf = x.new_zeros((total,) + tuple(x.shape[1:]),
                      dtype=torch.float32 if wide else x.dtype)
    buf[lo:lo + x.shape[0]] = x
    dist.all_reduce(buf)
    return buf.to(x.dtype) if wide else buf


class _GatherRows(torch.autograd.Function):
    """Forward: :func:`gather_rows`.  Backward: this rank's rows of the
    output's gradient.  Every rank computes the same loss from the same
    gathered tensor, so that gradient is the whole one on every rank, and
    the rank's rows are exactly its share; summing over ranks (as
    ``torch.distributed.nn.functional.all_gather`` does) would count it
    once a rank."""

    @staticmethod
    def forward(ctx, x, mesh, lo, total):
        ctx.lo, ctx.hi = lo, lo + x.shape[0]
        return gather_rows(x, mesh, lo, total)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.lo:ctx.hi], None, None, None


class _ShardRows(torch.autograd.Function):
    """Forward: rows ``lo:hi`` of a replicated tensor.  Backward: each
    rank's gradient of its rows gathered into the whole tensor's, so the
    gradient that reaches the replicated tensor is complete on every rank
    (a sharded call's input that needs a gradient: CCT's heads)."""

    @staticmethod
    def forward(ctx, x, mesh, lo, hi):
        ctx.mesh, ctx.lo, ctx.total = mesh, lo, x.shape[0]
        return x[lo:hi]

    @staticmethod
    def backward(ctx, grad):
        return (gather_rows(grad.contiguous(), ctx.mesh, ctx.lo, ctx.total),
                None, None, None)


def shard_rows(x, mesh: Mesh | None):
    """This rank's rows of a batch-leading tensor (anything else, and
    everything without a process group, as it is)."""
    if not is_distributed(mesh) or not isinstance(x, torch.Tensor):
        return x
    lo, hi = mesh.rows(x.shape[0])
    if x.requires_grad:
        return _ShardRows.apply(x, mesh, lo, hi)
    return x[lo:hi]


def all_gather_rows(x, mesh: Mesh | None):
    """The ranks' row blocks of a sharded call's output, in global order
    (a tensor; anything else as it is), differentiable: the backward is
    this rank's rows of the gradient."""
    if not is_distributed(mesh) or not isinstance(x, torch.Tensor):
        return x
    total = x.shape[0] * mesh.size
    return _GatherRows.apply(x, mesh, mesh.rank * x.shape[0], total)


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum of ``x`` over the ranks.  Backward: the sum of the
    output's gradient over the ranks, since each rank's gradient there is
    its own rows' part of the global one."""

    @staticmethod
    def forward(ctx, x):
        return _summed(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad)


def _summed(x: torch.Tensor) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out)
    all_reduce_sum.calls += 1
    all_reduce_sum.bytes += out.numel() * out.element_size()
    return out


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum of a small tensor (a layer's per-channel sums) over the
    ranks, differentiable (:class:`_AllReduceSum`); the identity without a
    process group.  ``all_reduce_sum.calls`` and ``.bytes`` count the
    all-reduces it made, forward and backward."""
    if not is_distributed(mesh):
        return x
    return _AllReduceSum.apply(x)


all_reduce_sum.calls = 0
all_reduce_sum.bytes = 0


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """A sharded call's rows of the global batch: rows ``lo:lo + n`` of
    ``total`` on ``mesh``'s rank."""
    mesh: Mesh
    lo: int
    total: int


_SHARD: BatchShard | None = None


@contextlib.contextmanager
def sharded_batch(mesh: Mesh | None, lo: int, total: int):
    """Inside, :func:`batch_shard` tells the layers of a sharded call that
    their batch is rows ``lo:`` of a global batch of ``total`` rows on
    ``mesh``; without a process group it tells them nothing."""
    global _SHARD
    prev = _SHARD
    if is_distributed(mesh):
        _SHARD = BatchShard(mesh, lo, total)
    try:
        yield
    finally:
        _SHARD = prev


def batch_shard() -> BatchShard | None:
    """The current sharded call's :class:`BatchShard`, or None (a whole
    batch on one process)."""
    return _SHARD


def all_reduce_grads(params, mesh: Mesh | None) -> int:
    """Sums the gradients of ``params`` over the ranks in place, as ONE
    ``all_reduce`` of one flat f32 buffer (a sum, not a mean: each rank
    holds its rows' share); returns the bytes reduced.  Each parameter is
    counted once, however many optimisers hold it."""
    if not is_distributed(mesh):
        return 0
    seen, grads = set(), []
    for p in params:
        if id(p) not in seen and p.grad is not None:
            seen.add(id(p))
            grads.append(p.grad)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return flat.numel() * flat.element_size()


def broadcast_object(obj, mesh: Mesh | None, src: int = 0):
    """Rank ``src``'s ``obj`` (picklable) on every rank."""
    if not is_distributed(mesh):
        return obj
    box = [obj if mesh.rank == src else None]
    dist.broadcast_object_list(
        box, src=src,
        device=mesh.device if mesh.backend == "nccl" else None)
    return box[0]


def barrier(mesh: Mesh | None) -> None:
    if is_distributed(mesh):
        dist.barrier()


def place_state(mesh: Mesh | None, trainer, state, src: int = 0):
    """Rank ``src``'s trainer state on every rank (the port's
    ``host_to_global`` contract): its params, Adam moments and steps,
    queues, bank and step, as the JAX-layout tree of
    ``trainer.state_to_jax``, and its generator's state.  Every rank, the
    source too, rebuilds its state from the broadcast copy, so the
    replicas start bitwise equal.  The identity without a process
    group."""
    # imported here: weights imports the models, whose layers import this
    # module for batch_shard
    from cmlpl_tpu_torch.weights import StateTree

    if not is_distributed(mesh):
        return state
    tree, gen = broadcast_object(
        (trainer.state_to_jax(state), state.generator.get_state())
        if mesh.rank == src else None, mesh, src)
    placed = trainer.state_from_jax(StateTree(tree))
    placed.generator.set_state(gen)
    return placed
