"""Shared model building blocks (``cmlpl_tpu/models/common.py``) and the
flax semantics the comparison zoo relies on: dropout with flax's mask,
BatchNorm with flax's running statistics, flax's scalar PReLU, and flax's
default initialisers (``cmlpl_tpu/core/init.py`` holds the torch-default
ones the BaseNets use).

The zoo's layers are PyTorch's own (``nn.Conv2d``, ``nn.Conv3d``,
``nn.Linear``, ``nn.LayerNorm``, whose default eps is flax's 1e-5) with
weights in torch's layout; the flax layouts are converted in
:mod:`cmlpl_tpu_torch.weights`.  Initial weights
come from :func:`cmlpl_tpu_torch.weights.init_zoo_params`, which draws
them with the initialisers below, not from torch's defaults.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cmlpl_tpu_torch.core.mesh import all_reduce_sum, batch_shard
from cmlpl_tpu_torch.core.rng import uniform
from cmlpl_tpu_torch.device import compute_precision


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 normalisation over ``dim`` — the reference's ``Normalize(2)``
    (tools/models.py:81-90), no epsilon (matches ``x / ||x||``)."""
    return x / torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(kernel=2, stride=2) on NCHW, floor mode (torch default)."""
    return F.avg_pool2d(x, 2, 2)


def keep_mask(shape, rate: float, generator, device) -> torch.Tensor:
    """Flax's ``nn.Dropout`` mask: keep each element with probability
    ``1 - rate`` (a uniform draw below it).  ``generator``: a
    ``torch.Generator`` (or None, torch's default) or a ``CounterStream``
    (``core/rng.uniform``)."""
    return uniform(generator, shape, device) < 1.0 - rate


def dropout(z: torch.Tensor, rate: float, generator: torch.Generator | None,
            keep: torch.Tensor | None = None) -> torch.Tensor:
    """Flax's ``nn.Dropout``: the elements of ``keep`` (drawn from
    ``generator`` by :func:`keep_mask` when None) scaled by
    ``1 / (1 - rate)``, the others 0.  Inside a sharded call
    (``core/mesh.batch_shard``) the mask is drawn at the global batch's
    shape and cut to this rank's rows, so the generator advances as one
    process's does and the rows get that process's mask."""
    p = 1.0 - rate
    if p <= 0.0:
        return torch.zeros_like(z)
    if keep is None:
        shard = batch_shard()
        if shard is None:
            keep = keep_mask(z.shape, rate, generator, z.device)
        else:
            keep = keep_mask((shard.total,) + tuple(z.shape[1:]), rate,
                             generator, z.device)
            keep = keep[shard.lo:shard.lo + z.shape[0]]
    return torch.where(keep, z / p, torch.zeros((), dtype=z.dtype,
                                                device=z.device))


class Dropout(nn.Module):
    """Flax's ``nn.Dropout`` as a layer: the identity in eval mode or at
    rate 0, else :func:`dropout` with a mask from ``generator``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.rate == 0:
            return x
        return dropout(x, self.rate, generator)


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` over dim 1 (the channels of NC... tensors).

    Train mode normalises by the batch's mean and biased variance, as
    ``F.batch_norm`` does, and updates the running statistics the flax
    way: ``ra = momentum * ra + (1 - momentum) * batch``, with the
    **biased** batch variance (``F.batch_norm`` would blend in the
    unbiased one, and its ``momentum`` is flax's ``1 - momentum``).  Flax
    computes the variance as E[x²] − E[x]², clipped at 0; this takes
    ``torch.var_mean``'s, which differs from it by rounding.  Eval mode
    uses the running statistics.  Flax's defaults: momentum 0.99, eps
    1e-5.

    Inside a sharded call (``core/mesh.batch_shard``, the batch split over
    ranks) train mode normalises by the **global** batch's mean and biased
    variance, each a sum over the ranks (``core/mesh.all_reduce_sum``,
    differentiable: its backward sums the ranks' gradients): Σx, then
    Σ(x − mean)², two passes as ``torch.var_mean`` takes them.  Flax's
    one-pass E[x²] − E[x]² cancels where a channel's mean dwarfs its
    spread (SSRN's residual blocks at PaviaU width: its step-1 gradients
    parted from the two-pass ones by 1.6e-3 of a tensor's largest).  Every
    rank updates its running statistics from the same sums, so the
    replicas stay equal."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = [0] + list(range(2, x.dim()))
        shard = batch_shard()
        if shard is None:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=dims, correction=0)
                self._update_running(mean, var)
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, self.eps)
        n = shard.total * math.prod(x.shape[2:])
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mean = all_reduce_sum(x.sum(dims), shard.mesh) / n
        xc = x - mean.view(shape)
        var = all_reduce_sum((xc * xc).sum(dims), shard.mesh) / n
        with torch.no_grad():
            self._update_running(mean, var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return xc * mul.view(shape) + self.bias.view(shape)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)


class PReLU(nn.Module):
    """Flax's ``nn.PReLU``: one scalar slope (``negative_slope``, 0.01 at
    init) for every element."""

    def __init__(self):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(0.01))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.negative_slope * x)


class F32Model(nn.Module):
    """Base of the zoo's models: ``forward`` runs ``_forward`` with TF32
    off for its convolutions and matmuls (``device.compute_precision``),
    so the zoo is f32 on the card as in the JAX package."""

    def forward(self, *args, **kwargs):
        with compute_precision("float32"):
            return self._forward(*args, **kwargs)


# --------------------------------------------------------------------------
# flax's initialisers, on flax-layout shapes (kernels (..., in, out)), drawn
# from a numpy Generator
# --------------------------------------------------------------------------

def _fans(shape) -> tuple[float, float]:
    """``jax.nn.initializers``' fans: in = shape[-2], out = shape[-1], both
    times the product of the other dims (the receptive field)."""
    field = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    return shape[-2] * field, shape[-1] * field


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Standard normal truncated to [-2, 2], by redrawing outliers (the
    distribution of ``jax.random.truncated_normal(key, -2, 2)``)."""
    z = rng.standard_normal(shape)
    bad = np.abs(z) > 2
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > 2
    return z


def lecun_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Flax's default ``nn.Conv``/``nn.Dense`` kernel init:
    ``variance_scaling(1, "fan_in", "truncated_normal")``."""
    fan_in, _ = _fans(shape)
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    return (_truncated_normal(rng, shape) * std).astype(np.float32)


def xavier_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """``variance_scaling(1, "fan_avg", "normal")``."""
    fan_in, fan_out = _fans(shape)
    std = np.sqrt(2.0 / (fan_in + fan_out))
    return (rng.standard_normal(shape) * std).astype(np.float32)


def xavier_uniform(rng: np.random.Generator, shape) -> np.ndarray:
    """``variance_scaling(1, "fan_avg", "uniform")``."""
    fan_in, fan_out = _fans(shape)
    bound = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def normal(stddev: float):
    """``nn.initializers.normal(stddev)``."""
    def init(rng: np.random.Generator, shape) -> np.ndarray:
        return (rng.standard_normal(shape) * stddev).astype(np.float32)

    return init


def torch_uniform(rng: np.random.Generator, shape,
                  fan_in: int | None = None) -> np.ndarray:
    """torch's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)), for a
    kernel (fan_in: all dims but the last) or, given ``fan_in``, a bias
    (``cmlpl_tpu/core/init.py``)."""
    fan_in = int(np.prod(shape[:-1])) if fan_in is None else fan_in
    bound = 1.0 / np.sqrt(fan_in)
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def constant(value: float):
    def init(rng: np.random.Generator, shape) -> np.ndarray:
        return np.full(shape, value, np.float32)

    return init


zeros, ones = constant(0.0), constant(1.0)
