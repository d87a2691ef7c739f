"""Contrastive objectives (``cmlpl_tpu/objectives/contrastive.py``): NT-Xent
and the U2PL-style memory-bank loss.

- :func:`nt_xent` is the reference's ``ContrastiveLoss``
  (tools/models.py:14-39, SimCLR NT-Xent over a 2B cosine-sim matrix).
- :func:`memobank_contrastive` is the JAX package's pixel-vector
  re-derivation of ``compute_contra_memobank_loss`` (loss_helper.py:39-219)
  over a fixed-size per-class bank, :class:`MemoBankState`.

The bank's random choices come from uniforms drawn with the rest of a
step's draws (:func:`memobank_draws`, from the step's generator or
counter stream) where the JAX package splits keys; they hold its
distribution, not its bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from cmlpl_tpu_torch.core.rng import uniform
from cmlpl_tpu_torch.ops.noise import choose


def _l2(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / (norm.clamp_min(eps) if eps else norm)


def nt_xent(emb_i: torch.Tensor, emb_j: torch.Tensor,
            temperature: float = 0.5) -> torch.Tensor:
    """SimCLR NT-Xent (models.py:14-39)."""
    b = emb_i.shape[0]
    z = torch.cat([_l2(emb_i), _l2(emb_j)], dim=0)
    sim = z @ z.T                      # cosine: the rows are unit
    pos = torch.cat([torch.diagonal(sim, b), torch.diagonal(sim, -b)])
    num = torch.exp(pos / temperature)
    mask = 1.0 - torch.eye(2 * b, dtype=sim.dtype, device=sim.device)
    den = torch.sum(mask * torch.exp(sim / temperature), dim=1)
    return torch.sum(-torch.log(num / den)) / (2 * b)


class MemoBankState(NamedTuple):
    """Per-class FIFO of negative features (the host-side Python queues of
    loss_helper.py:19-36).  A named tuple, as in the JAX package, so that
    ``torch.func`` transforms carry it."""
    feats: torch.Tensor   # (num_classes, size, feat_dim)
    count: torch.Tensor   # (num_classes,) int32 rows ever written
    ptr: torch.Tensor     # (num_classes,) int32 write pointer


def memobank_init(num_classes: int, size: int, feat_dim: int,
                  device=None) -> MemoBankState:
    return MemoBankState(
        feats=torch.zeros((num_classes, size, feat_dim), device=device),
        count=torch.zeros((num_classes,), dtype=torch.int32, device=device),
        ptr=torch.zeros((num_classes,), dtype=torch.int32, device=device))


class MemoBankDraws(NamedTuple):
    """The uniforms of a :func:`memobank_contrastive` call, one row a
    class: the pushed rows (C, max_push), the anchors (C, num_queries) and
    the negatives (C, num_queries * num_negatives).  Their shapes are the
    config's, whatever the step's forward, so a step draws them with its
    other draws; the choices are made from them (``ops/noise.choose``)
    once the masks exist."""
    push: torch.Tensor
    anchors: torch.Tensor
    negatives: torch.Tensor


def memobank_draws(source, num_classes: int, device, *,
                   num_queries: int = 256, num_negatives: int = 50,
                   max_push: int = 64) -> MemoBankDraws:
    """The uniforms of one bank call from the draw source ``source`` (a
    generator or a ``core/rng.CounterStream``), in the order the choices
    use them: push, anchors, negatives."""
    return MemoBankDraws(*(
        uniform(source, (num_classes, n), device)
        for n in (max_push, num_queries, num_queries * num_negatives)))


def _rows(num_classes: int, size: int, pos: torch.Tensor) -> torch.Tensor:
    """Flat row ids of a (num_classes, size, D) bank viewed (C * size, D):
    class c's row ``pos[c, j]`` for each (c, j), flattened."""
    cls = torch.arange(num_classes, device=pos.device)[:, None]
    return (cls * size + pos).reshape(-1)


@torch.no_grad()
def memobank_update(bank: MemoBankState, feats: torch.Tensor,
                    class_mask: torch.Tensor,
                    u_push: torch.Tensor) -> MemoBankState:
    """A new bank with up to ``max_push`` candidates pushed per class,
    ``max_push = u_push.shape[1]`` (at most the bank's size).

    ``class_mask`` (num_classes, N) bool: each class's candidate negatives.
    A class takes ``max_push`` rows of its candidates with replacement (by
    its uniforms ``u_push``) and writes the first min(candidates,
    max_push) of them at its pointer; the classes write disjoint rows, so
    the JAX package's scan over them is one out-of-place ``index_copy``
    of the bank's rows here, the same eagerly, under ``vmap`` and traced."""
    num_classes, size, d = bank.feats.shape
    max_push = u_push.shape[-1]
    idx = choose(u_push, class_mask)                         # (C, P)
    n_push = class_mask.sum(dim=1).clamp(max=max_push).to(torch.int32)
    steps = torch.arange(max_push, device=feats.device)
    rows = _rows(num_classes, size, (bank.ptr[:, None] + steps) % size)
    flat = bank.feats.reshape(num_classes * size, d)
    valid = (steps < n_push[:, None]).reshape(-1, 1)
    new = torch.where(valid, feats.index_select(0, idx.reshape(-1)),
                      flat.index_select(0, rows))
    return MemoBankState(
        feats=flat.index_copy(0, rows, new).reshape(num_classes, size, d),
        count=bank.count + n_push, ptr=(bank.ptr + n_push) % size)


def memobank_contrastive(rep, rep_teacher, probs, labels, low_entropy_mask,
                         high_entropy_mask, bank: MemoBankState,
                         u: MemoBankDraws, *, temperature: float = 0.5,
                         delta_p: float = 0.3, low_rank: int = 3,
                         high_rank: int = 9):
    """InfoNCE against class prototypes with memory-bank negatives
    (loss_helper.py:39-219, pixel-vector domain); returns (loss, the
    updated bank).

    ``rep`` (N, D) student features, ``rep_teacher`` (N, D) teacher
    features and ``probs`` (N, C) teacher probabilities (both taken
    without gradient), ``labels`` (N,) class ids, the two (N,) entropy
    masks; ``u`` the call's uniforms (:func:`memobank_draws`), whose
    shapes set ``max_push``, ``num_queries`` and ``num_negatives``.  Per
    class c: anchors are low-entropy pixels of class c with prob_c >
    delta_p; the positive is the mean teacher feature of class c's
    low-entropy pixels; the negatives are bank rows of class c, first
    refreshed from high-entropy pixels not labeled c whose class-c
    probability ranks in [low_rank, high_rank).  Classes without anchors
    or negatives contribute zero.  The JAX package's optional momentum
    prototypes have no caller there and are not carried."""
    rep_teacher = rep_teacher.detach()
    probs = probs.detach()
    d = rep.shape[1]
    num_classes = probs.shape[1]
    # a comparison, not F.one_hot, whose range check reads the labels on
    # the host, which a traced step cannot
    onehot = (labels[:, None] == torch.arange(
        num_classes, device=labels.device)).float()                 # (N, C)
    low_valid = onehot * low_entropy_mask[:, None]
    order = torch.argsort(-probs, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1)
    in_rank_window = (ranks >= low_rank) & (ranks < high_rank)
    anchor_mask = (probs > delta_p) & (low_valid > 0)
    negative_mask = ((onehot == 0) & high_entropy_mask[:, None]
                     & in_rank_window)
    weights = low_valid / low_valid.sum(dim=0, keepdim=True).clamp_min(1.0)
    protos = weights.T @ rep_teacher                                 # (C, D)

    bank = memobank_update(bank, rep_teacher, negative_mask.T, u.push)

    num_queries = u.anchors.shape[-1]
    num_negatives = u.negatives.shape[-1] // num_queries
    a_idx = choose(u.anchors, anchor_mask.T)                        # (C, Q)
    # index_select, not rep[a_idx]: its backward (index_add_) sums the
    # repeated anchors in one order on the CPU, where the backward of
    # advanced indexing adds them atomically from several threads
    anchors = rep.index_select(0, a_idx.reshape(-1)).reshape(
        num_classes, num_queries, d)                       # (C, Q, D) grads
    # negatives: rows drawn uniformly from each class's filled rows
    size = bank.feats.shape[1]
    filled = (torch.arange(size, device=rep.device)
              < bank.count.clamp(max=size)[:, None])
    n_idx = choose(u.negatives, filled)
    negs = bank.feats.reshape(num_classes * size, d).index_select(
        0, _rows(num_classes, size, n_idx)).reshape(
            num_classes, num_queries, num_negatives, d)
    pos = protos[:, None, None, :].expand(num_classes, num_queries, 1, d)
    all_feat = torch.cat([pos, negs], dim=2)                # (C, Q, 1+K, D)
    logits = torch.einsum("cqd,cqkd->cqk", _l2(anchors, eps=1e-12),
                          _l2(all_feat, eps=1e-12)) / temperature
    loss_c = torch.mean(-F.log_softmax(logits, dim=2)[..., 0], dim=1)
    valid = (anchor_mask.sum(dim=0) > 0) & (bank.count > 0)
    loss = torch.where(valid, loss_c, torch.zeros_like(loss_c)).sum()
    return loss / valid.sum().clamp_min(1), bank
