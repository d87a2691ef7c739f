"""Supervised classification loss (``cmlpl_tpu/objectives/supervised.py``).

Only :func:`cross_entropy` is on the CMLPL path; RCE, the entropy-filtered
CE and OHEM wait for ROADMAP item 9 ("Extras").
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
