"""Supervised and robust classification losses
(``cmlpl_tpu/objectives/supervised.py``).

- :func:`cross_entropy`: mean CE over int labels (torch
  ``nn.CrossEntropyLoss`` semantics, reference train.py:129); the one on
  the trainers' path.
- :func:`reverse_cross_entropy`: RCE with clamped one-hot targets
  (loss_helper.py:222-239), for pixel-vector logits.
- :func:`entropy_filtered_ce`: U2PL-style CE that drops the
  highest-entropy fraction of examples (loss_helper.py:242-261).
- :func:`ohem_cross_entropy`: online hard example mining CE
  (loss_helper.py:477-557), vector domain.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IGNORE = -1  # ignored-label marker


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = IGNORE) -> torch.Tensor:
    """Mean softmax cross-entropy; entries with ``labels == ignore`` are
    excluded from the mean, whose denominator is at least 1."""
    valid = labels != ignore
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[:, None])[:, 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)


def reverse_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          num_classes: int, ignore: int = IGNORE,
                          clamp_min: float = 1e-4) -> torch.Tensor:
    """RCE = -sum_c p_c log(clamp(onehot_c)) averaged over valid
    examples."""
    valid = labels != ignore
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    onehot = F.one_hot(safe, num_classes).float().clamp(clamp_min, 1.0)
    probs = F.softmax(logits, dim=-1)
    rce = -torch.sum(probs * torch.log(onehot), dim=-1) * valid
    return rce.sum() / valid.sum().clamp(min=1)


def entropy_filtered_ce(logits: torch.Tensor, labels: torch.Tensor,
                        teacher_logits: torch.Tensor, percent: float,
                        ignore: int = IGNORE) -> torch.Tensor:
    """Drop the examples at or above the ``percent`` percentile of the
    teacher's entropy (``np.percentile``'s linear interpolation over the
    valid ones), then CE over the rest, weighted by batch / kept as in the
    reference."""
    probs = F.softmax(teacher_logits.detach(), dim=-1)
    entropy = -torch.sum(probs * torch.log(probs + 1e-10), dim=-1)
    valid = labels != ignore
    n_valid = valid.sum().clamp(min=1)
    order = torch.sort(torch.where(valid, entropy,
                                   torch.full_like(entropy, torch.inf)))[0]
    k = ((percent / 100.0) * (n_valid - 1)).clamp(0, order.shape[0] - 1)
    lo, hi = k.floor().long(), k.ceil().long()
    thresh = order[lo] + (order[hi] - order[lo]) * (k - lo)
    keep = valid & ~(entropy >= thresh)
    kept = torch.where(keep, labels, torch.full_like(labels, ignore))
    weight = labels.shape[0] / keep.sum().clamp(min=1)
    return weight * cross_entropy(logits, kept, ignore)


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       thresh: float = 0.7, min_kept: int = 256,
                       ignore: int = IGNORE) -> torch.Tensor:
    """OHEM CE (vector domain): keep the examples whose predicted
    true-class probability is at most max(thresh, that of the
    ``min_kept``-th hardest); mean CE over them."""
    valid = labels != ignore
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    probs = F.softmax(logits.detach(), dim=-1)
    true_prob = probs.gather(-1, safe[:, None])[:, 0]
    true_prob = torch.where(valid, true_prob, torch.ones_like(true_prob))
    order = torch.sort(true_prob)[0]
    kth = order[max(min(min_kept, logits.shape[0]) - 1, 0)]
    keep = (true_prob <= kth.clamp_min(thresh)) & valid
    kept = torch.where(keep, labels, torch.full_like(labels, ignore))
    return cross_entropy(logits, kept, ignore)
