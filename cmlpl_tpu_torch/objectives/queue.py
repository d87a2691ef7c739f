"""Pseudo-label memory queue (``cmlpl_tpu/objectives/queue.py``).

The reference keeps two FIFO queues of (1024-d features, class probs),
written in place under ``torch.no_grad`` (``train.py:138-145`` allocation,
``:212-237`` smoothing + update).  The port does the same: the queue's
tensors are overwritten in place, and its pointer is a host integer, so a
write needs no device synchronisation.  A step must smooth with the queue
(:func:`memory_smooth`) before it writes the step's rows
(:func:`queue_update`): smoothing reads the old contents.

An exported training run writes out of place (:func:`queue_write`): the
rows go to ``(ptr + arange(n)) % size`` by ``index_copy``, the pointer is a
0-d tensor, and the values equal :func:`queue_update`'s.

On a ("data", "model") mesh a queue holds this model rank's columns of
the features, ``(size, feat_dim / tp)`` (JAX's ``P(None, "model")``):
given ``tp``, the mesh, smoothing contracts the rank's columns of the
features against them and sums the scores over the model ranks before
the softmax, and a write keeps the rank's columns.  The probs and the
pointer are replicated.

Pointer semantics: the reference advances the pointer by the constant 256
instead of the written row count, and seeds ``queue_ptr1`` from the
*already updated* ``queue_ptr`` (``train.py:234-237``).  Like the JAX
package, the port implements the *intended* semantics (advance by n,
independent pointers), which is identical for the default configuration.
"""

from __future__ import annotations

import dataclasses

import torch

from cmlpl_tpu_torch.core import tp as tpc


@dataclasses.dataclass
class QueueState:
    feats: torch.Tensor  # (size, feat_dim) float32
    probs: torch.Tensor  # (size, num_classes) float32
    ptr: int


def queue_init(size: int, feat_dim: int, num_classes: int,
               device=None) -> QueueState:
    """Zero-initialised queue (reference train.py:139-144)."""
    return QueueState(
        feats=torch.zeros((size, feat_dim), device=device),
        probs=torch.zeros((size, num_classes), device=device),
        ptr=0)


@torch.no_grad()
def memory_smooth(feats: torch.Tensor, probs: torch.Tensor,
                  queue: QueueState, alpha: float,
                  temperature: float, tp=None) -> torch.Tensor:
    """Pseudo-label memory smoothing (reference train.py:213-219):

        A = rownorm(exp(feats @ queue_feats.T / T))   [== softmax]
        probs <- alpha * probs + (1 - alpha) * A @ queue_probs
    """
    scores = tpc.sum_partials(tpc.slice_cols(feats, tp) @ queue.feats.T, tp)
    a = torch.softmax(scores / temperature, dim=1)
    return alpha * probs + (1.0 - alpha) * (a @ queue.probs)


@torch.no_grad()
def queue_update(queue: QueueState, new_feats: torch.Tensor,
                 new_probs: torch.Tensor, tp=None) -> None:
    """FIFO write of n rows at the pointer, modulo the queue size, in
    place: at most two contiguous slices.  Rows are the second-last dim,
    so a seed-stacked queue ((seeds, size, ...), one pointer: every seed
    writes as many rows a step) takes each seed's rows at once."""
    size = queue.feats.shape[-2]
    n = new_feats.shape[-2]
    if n > size:
        raise ValueError(f"{n} rows do not fit a queue of {size}")
    new_feats = tpc.slice_cols(new_feats, tp)
    head = min(n, size - queue.ptr)
    for dst, src in ((queue.feats, new_feats), (queue.probs, new_probs)):
        dst[..., queue.ptr:queue.ptr + head, :] = src[..., :head, :]
        dst[..., :n - head, :] = src[..., head:, :]
    queue.ptr = (queue.ptr + n) % size


def queue_write(queue: QueueState, new_feats: torch.Tensor,
                new_probs: torch.Tensor) -> QueueState:
    """:func:`queue_update` out of place, for a traced step: the rows at
    ``(ptr + arange(n)) % size``, the pointer a 0-d integer tensor.
    Returns the new queue."""
    size = queue.feats.shape[-2]
    n = new_feats.shape[-2]
    if n > size:
        raise ValueError(f"{n} rows do not fit a queue of {size}")
    rows = (queue.ptr + torch.arange(n, device=new_feats.device)) % size
    return QueueState(queue.feats.index_copy(-2, rows, new_feats),
                      queue.probs.index_copy(-2, rows, new_probs),
                      (queue.ptr + n) % size)
