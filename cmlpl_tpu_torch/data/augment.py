"""Patch-level augmentations (``cmlpl_tpu/data/augment.py``; reference
``hsi_loader.py:58-107``, dead code there) on (B, w, w, C) batches, each
drawn from an explicit draw source: a ``torch.Generator`` or an exported
run's ``CounterStream`` (``core/rng.py``).  They hold the JAX package's
distributions, not its bits.
"""

from __future__ import annotations

import torch

from cmlpl_tpu_torch.core.rng import integers, uniform
from cmlpl_tpu_torch.ops.noise import masked_choice, normal


def _per_row(mask: torch.Tensor) -> torch.Tensor:
    return mask[:, None, None, None]


def random_flip(g: torch.Generator, xp: torch.Tensor) -> torch.Tensor:
    """Independent horizontal and vertical flips per batch element
    (hsi_loader.py:58-68), each with probability 1/2."""
    b = xp.shape[0]
    do_h, do_v = uniform(g, (2, b), xp.device) < 0.5
    xp = torch.where(_per_row(do_h), torch.flip(xp, dims=(2,)), xp)
    return torch.where(_per_row(do_v), torch.flip(xp, dims=(1,)), xp)


def random_rot90(g: torch.Generator, xp: torch.Tensor) -> torch.Tensor:
    """A uniform k * 90 degree rotation per element (hsi_loader.py:70-88)."""
    b = xp.shape[0]
    k = integers(g, 4, (b,), xp.device)
    rots = torch.stack([torch.rot90(xp, i, dims=(1, 2)) for i in range(4)])
    return rots[k, torch.arange(b, device=xp.device)]


def radiation_noise(g: torch.Generator, x: torch.Tensor,
                    alpha_range=(0.9, 1.1), beta: float = 1.0 / 25
                    ) -> torch.Tensor:
    """alpha * x + beta * N(0, 1), alpha uniform per element of the batch
    (hsi_loader.py:90-94).  alpha is f32, so a bf16 ``x`` comes back f32,
    as in the JAX package."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    lo, hi = alpha_range
    alpha = lo + (hi - lo) * uniform(g, shape, x.device)
    return alpha * x + beta * normal(g, x.shape, x.dtype, x.device)


def mixture_noise(g: torch.Generator, x: torch.Tensor, labels: torch.Tensor,
                  beta: float = 1.0 / 25) -> torch.Tensor:
    """Each element blended with a partner of the same class drawn from
    the batch (itself allowed), with uniform positive weights, plus
    Gaussian noise (the JAX package's re-derivation of the broken
    hsi_loader.py:96-107)."""
    b = x.shape[0]
    shape = (b,) + (1,) * (x.dim() - 1)
    a1, a2 = (0.01 + 0.99 * uniform(g, (2, b), x.device)).reshape(2, *shape)
    partner = masked_choice(g, labels[:, None] == labels[None, :], 1)[:, 0]
    mixed = (a1 * x + a2 * x[partner]) / (a1 + a2)
    return mixed + beta * normal(g, x.shape, x.dtype, x.device)
