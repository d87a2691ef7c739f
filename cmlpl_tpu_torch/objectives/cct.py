"""CCT consistency objective (``cmlpl_tpu/objectives/cct.py``; reference
``trian_CCT.py:76-84``)."""

from __future__ import annotations

import torch


def _kl_div_mean(log_input: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
    """``F.kl_div(log_input, target, reduction='mean')``: the mean over all
    B * C elements of ``target * (log target - log_input)``, 0 log 0 = 0.
    Written out because ``F.kl_div`` warns on every 'mean' call."""
    return torch.mean(torch.xlogy(target, target) - target * log_input)


def softmax_js_loss(logits: torch.Tensor, target_probs: torch.Tensor,
                    epsilon: float = 1e-5) -> torch.Tensor:
    """Symmetric JS-style consistency between a softmax over ``logits`` and
    fixed (detached) ``target_probs``:

        M    = (softmax(logits) + targets) / 2
        loss = (KL(log_softmax(logits), M) + KL(log(targets + eps), M)) / 2

    with torch's elementwise-mean KL (divides by B * C)."""
    target_probs = target_probs.detach()
    m = (torch.softmax(logits, dim=1) + target_probs) * 0.5
    kl1 = _kl_div_mean(torch.log_softmax(logits, dim=1), m)
    kl2 = _kl_div_mean(torch.log(target_probs + epsilon), m)
    return (kl1 + kl2) * 0.5
