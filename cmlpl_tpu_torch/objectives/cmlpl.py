"""CMLPL objective terms (``cmlpl_tpu/objectives/cmlpl.py``, reference
``train.py:191-271``).

Pure functions over logits, features and probabilities.  Callers detach
what the reference detaches, so one backward over both networks equals the
reference's two.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def adaptive_threshold(epoch: int, num_epochs: int, thr: float = 1.0
                       ) -> float:
    """Confidence threshold decaying from ``thr`` over training
    (train.py:147-148): thr * exp(-0.5 (epoch/E)^2), rounded to f32 as
    the JAX trainer passes it (``cmlpl_tpu/train/cmlpl.py:593-595``)."""
    return float(np.float32(float(np.exp(-0.5 * (epoch / num_epochs) ** 2))
                            * thr))


def soft_consistency(logits: torch.Tensor, target_probs: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Masked cross-network consistency (train.py:239-242):
    mean_i [ -sum_c log_softmax(logits)_ic * probs_ic * mask_i ].

    The mean divides by the batch size, not ``mask.sum()``, as the
    reference does."""
    logp = F.log_softmax(logits, dim=1)
    return (-(logp * target_probs).sum(dim=1) * mask).mean()


def pseudo_label_graph(probs_row: torch.Tensor, probs_col: torch.Tensor,
                       pos_thresh: float = 0.8, neg_thresh: float = 0.3
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pseudo-label graph with self-loops (train.py:249-256).

    Q0 = probs_row @ probs_col.T with unit diagonal; positives are entries
    of Q0 >= pos_thresh (row-normalised), negatives weight (1 - Q0) where
    Q0 <= neg_thresh (row-normalised with +1e-8).  Returns (Q, Q_n)."""
    q0 = probs_row @ probs_col.T
    eye = torch.eye(q0.shape[0], dtype=q0.dtype, device=q0.device)
    q0 = q0 * (1.0 - eye) + eye  # fill_diagonal_(1), train.py:250

    q = q0 * (q0 >= pos_thresh).to(q0.dtype)
    q = q / q.sum(dim=1, keepdim=True)

    qn = (1.0 - q0) * (q0 <= neg_thresh).to(q0.dtype)
    qn = qn / (qn.sum(dim=1, keepdim=True) + 1e-8)
    return q, qn


def graph_contrastive(feats_row: torch.Tensor, feats_col: torch.Tensor,
                      q: torch.Tensor, qn: torch.Tensor,
                      temperature: float) -> torch.Tensor:
    """Contrastive pseudo-label-graph loss for one network
    (train.py:246-265):

        sim   = rownorm(exp(feats_row @ feats_col.T / T))
        loss  = mean(-sum(log(sim) * Q, 1)) + mean(sum(log(sim + 1) * Q_n, 1))

    Rows are net-B features, columns net-E features; the caller detaches
    the side that must carry no gradient."""
    sim = torch.exp(feats_row @ feats_col.T / temperature)
    sim_probs = sim / sim.sum(dim=1, keepdim=True)
    pos_term = -(torch.log(sim_probs) * q).sum(dim=1)
    neg_term = (torch.log(sim_probs + 1.0) * qn).sum(dim=1)
    return pos_term.mean() + neg_term.mean()
