"""Cross Pseudo Supervision objective (``cmlpl_tpu/objectives/cps.py``;
reference ``trian_CPS.py:238-249``)."""

from __future__ import annotations

import torch

from cmlpl_tpu_torch.objectives.supervised import cross_entropy


def cps_cross_supervision(logits_a: torch.Tensor,
                          logits_b: torch.Tensor) -> torch.Tensor:
    """CE of ``logits_a`` against the argmax pseudo-labels of the detached
    ``logits_b``, the CPS cross-supervision term (trian_CPS.py:238-242)."""
    return cross_entropy(logits_a, logits_b.detach().argmax(dim=1))
