"""The collectives of the model axis (``core/mesh.create_mesh_2d``), each a
``torch.autograd.Function`` with its conjugate backward; GSPMD inserts
them in the JAX package (``cmlpl_tpu/train/cmlpl.py:124-135``).

Every model rank of a data rank runs the same rows and computes the same
loss from the same replicated tensors, so the gradient that reaches a
replicated tensor is whole on each of them:

- :func:`gather_cols` (a split layer's output, ``feat_spe``'s ``y``, made
  whole before the concat and the l2-norm): the exact zero-filled
  ``all_reduce`` of ``core/mesh.gather_cols``.  Backward: this rank's
  columns of the whole gradient;
- :func:`slice_cols` (a replicated input cut to the columns a split
  weight reads, the classifier's): backward gathers the ranks' column
  gradients, so the replicated input's gradient is whole;
- :func:`sum_partials` (the partial products of a split contraction, the
  classifier's logits and the queue's similarities): an ``all_reduce``
  over the model group.  Backward: the identity; each rank's loss is the
  one loss, and a backward that summed would count its gradient ``tp``
  times.

Without a model axis (``mesh`` None or tp = 1) each is the identity.
``core/mesh.TP_COLLECTIVES`` counts the all-reduces they make, forward
and backward: calls, bytes and host seconds.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cmlpl_tpu_torch.core import mesh as _mesh


def _gather(x: torch.Tensor, mesh) -> torch.Tensor:
    return _mesh.count_tp(_mesh.gather_cols, x.contiguous(), mesh)


def _sum(x: torch.Tensor, mesh) -> torch.Tensor:
    def reduce(t, mesh):
        wide = t.dtype in (torch.bfloat16, torch.float16)
        buf = t.float() if wide else t.contiguous().clone()
        dist.all_reduce(buf, group=mesh.model_group)
        return buf.to(t.dtype) if wide else buf

    return _mesh.count_tp(reduce, x, mesh)


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.lo, ctx.hi = mesh.model * x.shape[-1], (mesh.model + 1) * \
            x.shape[-1]
        return _gather(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.lo:ctx.hi], None


class _SliceCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        lo, hi = mesh.cols(x.shape[-1])
        return x[..., lo:hi]

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.mesh), None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _sum(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def gather_cols(x: torch.Tensor, mesh) -> torch.Tensor:
    """The model ranks' column blocks of ``x`` (last dim), whole."""
    if not _mesh.is_tp(mesh):
        return x
    return _GatherCols.apply(x, mesh)


def slice_cols(x: torch.Tensor, mesh) -> torch.Tensor:
    """This model rank's column block of a replicated ``x``."""
    if not _mesh.is_tp(mesh):
        return x
    return _SliceCols.apply(x, mesh)


def sum_partials(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the model ranks of their partial products ``x``."""
    if not _mesh.is_tp(mesh):
        return x
    return _SumPartials.apply(x, mesh)


def width(n: int, mesh) -> int:
    """This model rank's share of ``n`` columns (``n`` without a model
    axis)."""
    if not _mesh.is_tp(mesh):
        return n
    lo, hi = mesh.cols(n)
    return hi - lo
