"""Gaussian input views for the two-net trainer (``cmlpl_tpu/ops/noise.py``),
and the other samplers of the trainers' random draws.

The reference perturbs every training input with iid Gaussian noise
(train.py:157-184 draws a fresh ``torch.randn`` per tensor).  The draws
come from one explicit ``torch.Generator`` on the tensors' device, taken
in a fixed order, so a run is reproducible from its seed.  Philox is not
threefry: the views hold the JAX package's distribution, not its bits.

- A view is drawn in its tensor's dtype.  In bf16 the normal sampler is
  the JAX package's (:func:`normal`): ``jax.random.normal(key, shape,
  jnp.bfloat16)`` takes 128 values only, within |z| <= 2.890625, where
  ``torch.randn`` in bf16 would take thousands, out to 5 sigma.

- ``noise_impl="binom16"``: the standardised Binomial(16, 1/2),
  ``(popcount(16 random bits) - 8) / 2``: mean 0, variance 1, a 17-level
  lattice within 4 sigma.  PyTorch has no population count, so
  :func:`popcount16` counts the bits exactly with shifts and masks.
- ``noise_fused=True``: one draw per view over the labeled||unlabeled
  concatenation (4 draws instead of 8); same element distribution and
  independence between views.

Every sampler takes a draw source ``g``: the eager ``torch.Generator``, or
the :class:`~cmlpl_tpu_torch.core.rng.CounterStream` of an exported
training run (``core/rng.py``), whose f32 normal is ``sqrt(2) erfinv`` of a
24-bit uniform and whose bf16 normal takes the same 128 levels.
"""

from __future__ import annotations

import functools
import math

import torch

from cmlpl_tpu_torch.core.rng import (CounterStream, integers,
                                      normal_f32, uniform)


def popcount16(bits: torch.Tensor) -> torch.Tensor:
    """Exact population count of integers in [0, 2**16), by the SWAR
    method: sum adjacent 1-, 2-, 4- and 8-bit fields."""
    x = bits - ((bits >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x + (x >> 8)) & 0x1F


@functools.lru_cache(maxsize=None)
def _bf16_normal_levels(device: torch.device) -> torch.Tensor:
    """The 128 values of ``jax.random.normal`` in bf16, by the arithmetic
    of ``jax/_src/random.py`` (``_uniform``, ``_normal_real``), op by op in
    bf16 on the CPU: the uniform k/128 from 7 mantissa bits, mapped to
    [nextafter(-1, 0), 1) as ``u * (1 - lo) + lo`` and clamped at ``lo``,
    then ``sqrt(2) * erfinv``."""
    bf = torch.bfloat16
    lo = torch.tensor(-1 + 2 ** -8, dtype=bf)      # nextafter(-1, 0)
    u = torch.arange(128).to(bf) / 128
    v = torch.maximum(lo, u * (1 - lo) + lo)       # 1 - lo rounds to 2
    z = torch.tensor(math.sqrt(2), dtype=bf) * torch.erfinv(v.float()).to(bf)
    return z.to(device)


def normal(g: torch.Generator, shape, dtype: torch.dtype,
           device) -> torch.Tensor:
    """Standard normal draws of ``shape`` in ``dtype``: ``torch.randn``,
    except in bf16, where the JAX package's sampler takes one of its 128
    values (:func:`_bf16_normal_levels`) for a uniform 7-bit draw."""
    if dtype == torch.bfloat16:
        k = integers(g, 128, shape, device)
        return _bf16_normal_levels(torch.device(device))[k]
    if isinstance(g, CounterStream):
        return normal_f32(g, shape).to(dtype)
    return torch.randn(shape, generator=g, device=device, dtype=dtype)


def masked_choice(g: torch.Generator, mask: torch.Tensor,
                  n: int) -> torch.Tensor:
    """``n`` indices drawn uniformly, with replacement, from the true
    positions of each row of ``mask`` (..., N) -> (..., n) int64; 0 where
    a row has none (the callers gate on its count).  The counterpart of
    the JAX package's ``jax.random.categorical`` over 0 / -1e30 logits,
    with no host synchronisation: the k-th true position is found by a
    search of the row's running count."""
    csum = mask.long().cumsum(-1)
    total = csum[..., -1:]
    u = uniform(g, mask.shape[:-1] + (n,), mask.device)
    k = torch.minimum((u * total).long(), total - 1)
    return torch.searchsorted(csum, k, right=True).clamp(
        max=mask.shape[-1] - 1)


def make_noiser(noise_impl: str, scale: float):
    """Returns ``noisy(generator, a) -> a + scale * sample(a.shape)``,
    sampled in ``a.dtype`` on ``a.device``.  Its ``sample(generator,
    shape, dtype, device)`` and ``scale`` let a caller draw a view's noise
    before the tensor it perturbs exists (a fused run draws outside its
    vmap) and add it later, by the same two operations."""
    if noise_impl == "normal":
        def sample(g, shape, dtype, device):
            return normal(g, shape, dtype, device)
    elif noise_impl == "binom16":
        def sample(g, shape, dtype, device):
            bits = integers(g, 1 << 16, shape, device, torch.int32)
            return (popcount16(bits).to(dtype) - 8) * 0.5
    else:
        raise ValueError(f"unknown noise_impl {noise_impl!r} "
                         "(want 'normal' or 'binom16')")

    def noisy(g, a):
        return a + sample(g, a.shape, a.dtype, a.device) * scale

    noisy.sample = sample
    noisy.scale = scale
    return noisy


def two_net_views(noisy, fused: bool, g, xp_l, x_l, xp_u, x_u):
    """The 4 input views (net B patches/spectra, net E patches/spectra),
    each the labeled||unlabeled concatenation with its own noise draw.

    ``fused=False`` keeps the reference's 8 draws, noise before the
    concatenation; ``fused=True`` draws once per view over the
    concatenated tensor."""
    cat = lambda a, b: torch.cat([a, b], dim=0)  # noqa: E731
    if fused:
        xp, x = cat(xp_l, xp_u), cat(x_l, x_u)
        return noisy(g, xp), noisy(g, x), noisy(g, xp), noisy(g, x)
    return (cat(noisy(g, xp_l), noisy(g, xp_u)),
            cat(noisy(g, x_l), noisy(g, x_u)),
            cat(noisy(g, xp_l), noisy(g, xp_u)),
            cat(noisy(g, x_l), noisy(g, x_u)))
