"""Distribution-matching losses (``cmlpl_tpu/objectives/mmd.py``).

The reference imports ``Distribution_Loss(loss='mmd')`` from a module
``regularizer`` that is not in its repo (``trian_CPS.py:11,163``); the JAX
package supplies it: a multi-kernel RBF MMD plus the usual distance menu.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    y2 = torch.sum(y * y, dim=1, keepdim=True)
    return x2 + y2.T - 2.0 * (x @ y.T)


def mmd_loss(x: torch.Tensor, y: torch.Tensor, num_kernels: int = 5,
             kernel_mul: float = 2.0) -> torch.Tensor:
    """Multi-kernel RBF maximum mean discrepancy between sample sets."""
    n = x.shape[0]
    z = torch.cat([x, y], dim=0)
    d2 = _pairwise_sq_dists(z, z)
    # median-free bandwidth heuristic: the mean off-diagonal distance
    m = z.shape[0]
    bandwidth = torch.sum(d2) / (m * m - m)
    bandwidth = bandwidth / (kernel_mul ** (num_kernels // 2))
    kernels = sum(torch.exp(-d2 / (bandwidth * (kernel_mul ** i) + 1e-12))
                  for i in range(num_kernels))
    return (torch.mean(kernels[:n, :n]) + torch.mean(kernels[n:, n:])
            - 2.0 * torch.mean(kernels[:n, n:]))


def distribution_loss(x: torch.Tensor, y: torch.Tensor,
                      loss: str = "mmd") -> torch.Tensor:
    """The ``Distribution_Loss`` menu: mmd / mse / kl / cosine."""
    if loss == "mmd":
        return mmd_loss(x, y)
    if loss == "mse":
        return torch.mean(torch.square(x - y))
    if loss == "kl":
        px = F.log_softmax(x, dim=1)
        py = F.softmax(y, dim=1)
        return torch.mean(torch.sum(py * (torch.log(py + 1e-10) - px), dim=1))
    if loss == "cosine":
        xn = x / (torch.linalg.norm(x, dim=1, keepdim=True) + 1e-8)
        yn = y / (torch.linalg.norm(y, dim=1, keepdim=True) + 1e-8)
        return torch.mean(1.0 - torch.sum(xn * yn, dim=1))
    raise ValueError(f"unknown distribution loss {loss!r}")
