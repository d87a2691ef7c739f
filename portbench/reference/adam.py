"""Adam (Kingma and Ba 2015) with PyTorch's and optax's defaults: b1 0.9,
b2 0.999, eps 1e-8 outside the square root, bias-corrected."""

from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class Adam:
    """Adam over a dict of leaves (name -> tensor), updated by
    :meth:`step` out of place."""

    def __init__(self, params: dict, lr: float):
        self.lr = lr
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        c1, c2 = 1 - B1 ** self.t, 1 - B2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = B1 * self.m[k] + (1 - B1) * g
            self.v[k] = B2 * self.v[k] + (1 - B2) * g * g
            out[k] = p - self.lr * (self.m[k] / c1) / (
                torch.sqrt(self.v[k] / c2) + EPS)
        return out
