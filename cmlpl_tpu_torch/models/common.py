"""Shared model building blocks (``cmlpl_tpu/models/common.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 normalisation over ``dim`` — the reference's ``Normalize(2)``
    (tools/models.py:81-90), no epsilon (matches ``x / ||x||``)."""
    return x / torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(kernel=2, stride=2) on NCHW, floor mode (torch default)."""
    return F.avg_pool2d(x, 2, 2)
