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

Serving prepares each scene on rank 0 alone and hands it to every rank
bitwise (:func:`broadcast_scene`); each rank then maps its strip.

A single process (no ``torchrun`` environment) has a :class:`Mesh` of one
rank with no process group, and every function here is then the
identity.

The ("data", "model") mesh (:func:`create_mesh_2d`, the JAX package's
``create_mesh_2d`` and ``basenet_tp_shardings``): global rank r is data
index ``r // tp`` and model index ``r % tp``, the layout of JAX's
``devices.reshape(n // tp, tp)``, with one process group a data axis
(the ranks of one model index) and one a model axis (the ranks of one
data index).  Everything above runs over the **data** group: a rank's
rows, the row gathers, BatchNorm's sums and the gradients' all-reduce,
so a model rank repeats its data rank's rows and nothing is counted
``tp`` times.  The "model" axis splits the wide spectral path
(:func:`tp_dim`): ``feat_spe``'s 1,024 output features and bias, the
contraction rows of a ``classifier`` kernel (BaseNet2's 2,624-wide
concat, BaseNet1's 256), their Adam moments and CMLPL's queue
features; everything else is replicated.  GSPMD inserts the collectives
of that split in the JAX package; the port's layers call them
(``core/tp.py``), and a state carries its shards: ``*_state_from_jax``
slices them out of the whole JAX-layout tree (:func:`tp_shard_tree`)
and ``*_state_to_jax`` gathers them back (:func:`tp_gather_tree`, a
collective of the model ranks).  A 1-D mesh is the ``(size, 1)`` case,
with the default group as its data group.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections.abc import Mapping

import numpy as np
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


@dataclasses.dataclass
class CollectiveCount:
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0


#: the model axis's collectives (``core/tp.py``'s and the replicated
#: gradients' broadcast) since the last ``reset()``: calls, bytes of f32,
#: host seconds
TP_COLLECTIVES = CollectiveCount()


def count_tp(collective, x: torch.Tensor, *args, **kwargs):
    """``collective(x, ...)`` on the model axis, counted in
    :data:`TP_COLLECTIVES` (the bytes of its result, or of ``x`` when it
    works in place)."""
    t0 = time.perf_counter()
    out = collective(x, *args, **kwargs)
    TP_COLLECTIVES.seconds += time.perf_counter() - t0
    TP_COLLECTIVES.calls += 1
    TP_COLLECTIVES.bytes += (x if out is None else out).numel() * 4
    return out


#: the widths the "model" axis splits (feat_spe's output features,
#: BaseNet2's concat at w = 20, BaseNet1's joint feature): tp divides
#: them all
TP_WIDTHS = (1024, 2624, 256)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ("data", "model") mesh: this process's ``rank`` of ``size``,
    its ``device``, the default group's ``backend`` (None: one process
    and no group, where nothing is communicated), the model axis's size
    ``tp`` and this rank's two groups (``data_group`` None: the default
    group, a 1-D mesh; ``model_group`` None: no model axis)."""
    rank: int
    size: int
    device: torch.device
    backend: str | None = None
    tp: int = 1
    data_group: object = None
    model_group: object = None

    @property
    def data(self) -> int:
        """This rank's index on the data axis."""
        return self.rank // self.tp

    @property
    def data_size(self) -> int:
        return self.size // self.tp

    @property
    def model(self) -> int:
        """This rank's index on the model axis."""
        return self.rank % self.tp

    def rows(self, n: int) -> tuple:
        """(lo, hi): this rank's contiguous share of ``n`` rows, the
        data-th of ``data_size`` equal blocks (``P("data")`` of JAX)."""
        if n % self.data_size:
            raise ValueError(f"{n} rows do not divide over "
                             f"{self.data_size} data ranks")
        k = n // self.data_size
        return self.data * k, (self.data + 1) * k

    def cols(self, n: int) -> tuple:
        """(lo, hi): this rank's block of ``n`` columns on the model axis
        (``P(..., "model")``)."""
        if n % self.tp:
            raise ValueError(f"{n} columns do not divide over tp={self.tp}")
        k = n // self.tp
        return self.model * k, (self.model + 1) * k

    def __deepcopy__(self, memo):
        # a module copied with its mesh (the EMA teacher) keeps the groups
        return self


def create_mesh(device=None) -> Mesh:
    """The 1-D mesh of the default process group (one rank, no group,
    when none was initialised) on ``device`` (default: the rank's
    card)."""
    device = resolve_device(device)
    if not dist.is_initialized():
        return Mesh(0, 1, device)
    return Mesh(dist.get_rank(), dist.get_world_size(), device,
                dist.get_backend())


def create_mesh_2d(tp: int, device=None) -> Mesh:
    """The ("data", "model") mesh of the default group: ``world // tp``
    data ranks times ``tp`` model ranks, rank r at (r // tp, r % tp).
    Every rank must call it, in the same order as its other
    ``new_group`` calls.  ``tp`` divides the world and every width the
    model axis splits (:data:`TP_WIDTHS`, whose greatest common divisor
    is 64; on a host of 8 cards, 1, 2, 4 or 8); tp = 1 is
    :func:`create_mesh`'s mesh."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp < 1 or world % tp or any(n % tp for n in TP_WIDTHS):
        raise ValueError(
            f"tp={tp} must divide the {world} ranks and the widths the "
            f"model axis splits {TP_WIDTHS}")
    mesh = create_mesh(device)
    if tp == 1:
        return mesh
    data_groups = [dist.new_group(list(range(m, world, tp)))
                   for m in range(tp)]
    model_groups = [dist.new_group(list(range(d * tp, (d + 1) * tp)))
                    for d in range(world // tp)]
    return dataclasses.replace(mesh, tp=tp,
                               data_group=data_groups[mesh.rank % tp],
                               model_group=model_groups[mesh.rank // tp])


def is_distributed(mesh: Mesh | None) -> bool:
    """True when ``mesh`` has a process group (a world of one rank too),
    so its collectives run."""
    return mesh is not None and mesh.backend is not None


def is_multiprocess(mesh: Mesh | None) -> bool:
    """True when ``mesh`` spans more than one process."""
    return mesh is not None and mesh.size > 1


def is_tp(mesh: Mesh | None) -> bool:
    """True when ``mesh`` has a model axis of more than one rank."""
    return mesh is not None and mesh.tp > 1


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
    rank's ``x`` and whose other rows are the other data ranks': an
    ``all_reduce(SUM)`` of a zero-filled buffer, exact (``x + 0 = x``).
    Floats narrower than f32 go through f32 (exact both ways).  Not
    differentiable: see :func:`all_gather_rows`."""
    if not is_distributed(mesh):
        return x
    wide = x.dtype in (torch.bfloat16, torch.float16)
    buf = x.new_zeros((total,) + tuple(x.shape[1:]),
                      dtype=torch.float32 if wide else x.dtype)
    buf[lo:lo + x.shape[0]] = x
    dist.all_reduce(buf, group=mesh.data_group)
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
    total = x.shape[0] * mesh.data_size
    return _GatherRows.apply(x, mesh, mesh.data * x.shape[0], total)


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum of ``x`` over the data ranks.  Backward: the sum
    of the output's gradient over them, since each rank's gradient there
    is its own rows' part of the global one."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    all_reduce_sum.calls += 1
    all_reduce_sum.bytes += out.numel() * out.element_size()
    return out


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum of a small tensor (a layer's per-channel sums) over the
    data ranks, differentiable (:class:`_AllReduceSum`); the identity without a
    process group.  ``all_reduce_sum.calls`` and ``.bytes`` count the
    all-reduces it made, forward and backward."""
    if not is_distributed(mesh):
        return x
    return _AllReduceSum.apply(x, mesh.data_group)


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
    """Sums the gradients of ``params`` over the data ranks in place, as
    ONE ``all_reduce`` of one flat f32 buffer (a sum, not a mean: each
    rank holds its rows' share); returns the bytes reduced.  Each
    parameter is counted once, however many optimisers hold it.

    On a 2-D mesh a split parameter's gradient (``tp_split``, set by the
    layer that holds it) is its shard's, and a replicated one's is whole
    on every model rank: neither is summed over the model axis.  The
    model ranks compute a replicated gradient each from the same rows,
    but a card's convolution backward need not round alike twice (its
    weight-gradient sums may use atomics), so model rank 0's replicated
    gradients are broadcast to its model group: the replicas stay
    bitwise equal, as one all-reduce keeps them on a 1-D mesh."""
    if not is_distributed(mesh):
        return 0
    seen, grads, split = set(), [], []
    for p in params:
        if id(p) not in seen and p.grad is not None:
            seen.add(id(p))
            (split if getattr(p, "tp_split", False) else grads).append(
                p.grad)
    replicated = sum(g.numel() for g in grads)
    grads += split
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.data_group)
    if is_tp(mesh) and replicated:
        rep = flat[:replicated].clone()
        count_tp(dist.broadcast, rep, src=mesh.rank - mesh.model,
                 group=mesh.model_group)
        flat[:replicated] = rep
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


#: :func:`broadcast_scene`'s calls since the last ``reset()``: calls, bytes
#: of the scenes' tensors and labels, host seconds of the tensors'
#: broadcasts (the object broadcast before them waits for the source)
SCENE_BROADCASTS = CollectiveCount()


def broadcast_scene(scene, mesh: Mesh | None):
    """Rank 0's prepared scene (``data/prep.PreparedScene``; None on
    the other ranks) on every rank, bitwise: its spec, labels (a host
    array), patch size and channels by :func:`broadcast_object`, its
    padded PCA cube and spectra by ``dist.broadcast`` of device tensors
    (NCCL, or gloo, which takes CUDA tensors for ``broadcast``) into
    tensors on ``mesh.device``.  Counted in :data:`SCENE_BROADCASTS`.
    The scene itself without a process group."""
    from cmlpl_tpu_torch.data.prep import PreparedScene

    if not is_distributed(mesh):
        return scene
    head = None
    if mesh.rank == 0:
        head = (scene.spec, scene.labels, scene.patch_size, scene.n_pc,
                tuple(scene.padded_pca.shape), tuple(scene.spectra.shape))
    spec, labels, patch_size, n_pc, cube_shape, spectra_shape = \
        broadcast_object(head, mesh)
    t0 = time.perf_counter()
    if mesh.rank == 0:
        tensors = [t.to(mesh.device, torch.float32).contiguous()
                   for t in (scene.padded_pca, scene.spectra)]
    else:
        tensors = [torch.empty(s, dtype=torch.float32, device=mesh.device)
                   for s in (cube_shape, spectra_shape)]
    for t in tensors:
        dist.broadcast(t, src=0)
    SCENE_BROADCASTS.seconds += time.perf_counter() - t0
    SCENE_BROADCASTS.calls += 1
    SCENE_BROADCASTS.bytes += sum(t.numel() * 4 for t in tensors) \
        + labels.nbytes
    return PreparedScene(spec=spec, padded_pca=tensors[0],
                         spectra=tensors[1], labels=labels,
                         patch_size=patch_size, n_pc=n_pc)


def barrier(mesh: Mesh | None) -> None:
    if is_distributed(mesh):
        dist.barrier()


def place_state(mesh: Mesh | None, trainer, state, src: int = 0):
    """Rank ``src``'s trainer state on every rank (the port's
    ``host_to_global`` contract): its params, Adam moments and steps,
    queues, bank and step, as the whole JAX-layout tree of
    ``trainer.state_to_jax``, and its generator's state.  Every rank, the
    source too, rebuilds its state from the broadcast copy (on a 2-D mesh
    its shards of it), so the replicas start bitwise equal.  A sharded
    state is gathered first, by every rank: the ranks' states must all be
    sharded (as ``init_state`` and this function make them) or all whole
    (a fused run's).  The identity without a process group."""
    # imported here: weights imports the models, whose layers import this
    # module for batch_shard
    from cmlpl_tpu_torch.weights import StateTree

    if not is_distributed(mesh):
        return state
    sharded = is_sharded(state)
    tree = (trainer.state_to_jax(state)
            if sharded or mesh.rank == src else None)
    tree, gen = broadcast_object(
        (tree, state.generator.get_state()) if mesh.rank == src else None,
        mesh, src)
    placed = trainer.state_from_jax(StateTree(tree))
    placed.generator.set_state(gen)
    return placed


# -- the model axis -------------------------------------------------------- #
def tp_dim(path: str, ndim: int) -> int | None:
    """The dim of the JAX-layout leaf at ``path`` (``/``-joined) that the
    model axis splits, else None (replicated): the rules of the JAX
    package's ``basenet_tp_shardings`` (``cmlpl_tpu/core/mesh.py``
    ``:109-119``; a ``feat_spe`` kernel's output features, dim 1, and its
    bias; a ``classifier`` kernel's contraction rows, dim 0; they key on
    the path, so they match Adam's moments and an EMA copy too) and
    CMLPL's queue features (``cmlpl_tpu/train/cmlpl.py:155-157``)."""
    if "feat_spe" in path and ndim in (1, 2):
        return ndim - 1
    if "classifier" in path and ndim == 2:
        return 0
    if path.split("/")[0] in ("queue_w", "queue_s") and \
            path.endswith("/feats"):
        return 1
    return None


def _block(a, dim: int, mesh: Mesh):
    lo, hi = mesh.cols(a.shape[dim])
    return a[(slice(None),) * dim + (slice(lo, hi),)]


def tp_shard_tree(tree: Mapping, mesh: Mesh | None,
                  prefix: str = "") -> Mapping:
    """This model rank's shards of a nested JAX-layout tree (numpy
    leaves; ``prefix``: the tree's own path in a state): each leaf that
    :func:`tp_dim` splits cut to its block, the others as they are.  The
    tree itself without a model axis."""
    if not is_tp(mesh):
        return tree
    out = {}
    for name, v in tree.items():
        path = f"{prefix}{name}"
        if isinstance(v, Mapping):
            out[name] = tp_shard_tree(v, mesh, path + "/")
            continue
        a = np.asarray(v)
        dim = tp_dim(path, a.ndim)
        out[name] = a if dim is None else np.ascontiguousarray(
            _block(a, dim, mesh))
    return out


def gather_cols(x: torch.Tensor, mesh: Mesh, dim: int = -1) -> torch.Tensor:
    """The whole tensor of the model ranks' blocks of ``dim``, this rank's
    ``x`` among them: an ``all_reduce(SUM)`` over the model group of a
    zero-filled buffer, exact as :func:`gather_rows` is (bf16 through
    f32).  Not differentiable: see ``core/tp.gather_cols``."""
    dim = dim % x.dim()
    wide = x.dtype in (torch.bfloat16, torch.float16)
    shape = list(x.shape)
    shape[dim] *= mesh.tp
    buf = x.new_zeros(shape, dtype=torch.float32 if wide else x.dtype)
    k = x.shape[dim]
    buf.narrow(dim, mesh.model * k, k).copy_(x)
    dist.all_reduce(buf, group=mesh.model_group)
    return buf.to(x.dtype) if wide else buf


def tp_gather_tree(tree: Mapping, mesh: Mesh | None,
                   prefix: str = "") -> Mapping:
    """The whole tree of the model ranks' :func:`tp_shard_tree` shards: a
    collective that every rank of the model group calls.  The tree itself
    without a model axis."""
    if not is_tp(mesh):
        return tree
    out = {}
    for name, v in tree.items():
        path = f"{prefix}{name}"
        if isinstance(v, Mapping):
            out[name] = tp_gather_tree(v, mesh, path + "/")
            continue
        a = np.asarray(v)
        dim = tp_dim(path, a.ndim)
        out[name] = a if dim is None else gather_cols(
            torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device), mesh,
            dim).cpu().numpy()
    return out


def tp_of(module) -> Mesh | None:
    """The mesh whose model axis splits ``module``'s layers (a layer's
    ``tp``), or None: a whole module."""
    for m in module.modules():
        tp = getattr(m, "tp", None)
        if tp is not None:
            return tp
    return None


def is_sharded(state) -> bool:
    """True when a trainer state's modules hold model-axis shards."""
    for name in ("model", "net_b"):
        part = getattr(state, name, None)
        if part is not None:
            return tp_of(getattr(part, "model", part)) is not None
    return False


def assert_tp_placed(module, mesh: Mesh, what: str = "model") -> None:
    """Fails loudly if tensor parallelism silently degraded to
    replication (the JAX package's ``assert_tp_placed``): every
    ``feat_spe`` weight of ``module`` holds this rank's 1,024 / tp output
    rows and its bias as many."""
    want = TP_WIDTHS[0] // mesh.tp
    found = [(n, tuple(p.shape)) for n, p in module.named_parameters()
             if "feat_spe" in n]
    assert found and all(shape[0] == want for _, shape in found), (
        f"{what}: feat_spe is not split over the model axis (tp={mesh.tp}:"
        f" {want} rows a rank): {found}")
