"""Config-dict criterion factory (``cmlpl_tpu/objectives/criterion.py``;
reference ``loss_helper.py:264-346``): plain CE, class-weighted CE and
OHEM CE for the pixel-vector domain, chosen by the reference's cfg shape:

    cfg = {"criterion": {"type": "ohem", "kwargs": {...}},
           "dataset": {"ignore_label": -1},
           "net": {"aux_loss": {"loss_weight": 0.4}}}   # optional
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F

from cmlpl_tpu_torch.objectives.supervised import (cross_entropy,
                                                   ohem_cross_entropy)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           weights, ignore: int = -1) -> torch.Tensor:
    """CE with per-class weights (torch semantics: a weighted mean whose
    denominator is the sum of the selected classes' weights)."""
    valid = labels != ignore
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[:, None])[:, 0]
    w = torch.as_tensor(weights, dtype=logits.dtype,
                        device=logits.device)[safe] * valid
    return torch.sum(nll * w) / w.sum().clamp_min(1e-8)


def get_criterion(cfg: dict) -> Callable:
    """``loss(preds, target)`` from the reference's cfg-dict shape;
    ``preds`` is one logits tensor, or (main, aux) when ``net.aux_loss``
    has a positive weight (loss_helper.py:321-346)."""
    crit_cfg = cfg["criterion"]
    ignore = cfg.get("dataset", {}).get("ignore_label", -1)
    aux_weight = (cfg.get("net", {}).get("aux_loss", {}) or
                  {}).get("loss_weight", 0)
    kwargs = dict(crit_cfg.get("kwargs", {}))

    if crit_cfg["type"] == "ohem":
        base = functools.partial(
            ohem_cross_entropy, thresh=kwargs.get("thresh", 0.7),
            min_kept=int(kwargs.get("min_kept", 256)), ignore=ignore)
    elif kwargs.get("use_weight"):
        weights = kwargs.get("weights")
        if weights is None:
            raise ValueError(
                "use_weight requires explicit per-class 'weights' "
                "(the reference hard-codes 19 Cityscapes weights, "
                "loss_helper.py:292-315, not meaningful here)")
        base = functools.partial(weighted_cross_entropy, weights=weights,
                                 ignore=ignore)
    else:
        base = functools.partial(cross_entropy, ignore=ignore)

    if aux_weight > 0:
        def criterion(preds, target):
            main_pred, aux_pred = preds
            return base(main_pred, target) + aux_weight * base(aux_pred,
                                                               target)
        return criterion
    return base
