"""Gaussian input views for the two-net trainer (``cmlpl_tpu/ops/noise.py``).

The reference perturbs every training input with iid Gaussian noise
(train.py:157-184 draws a fresh ``torch.randn`` per tensor).  The draws
come from one explicit ``torch.Generator`` on the tensors' device, taken
in a fixed order, so a run is reproducible from its seed.  Philox is not
threefry: the views hold the JAX package's distribution, not its bits.

- ``noise_impl="binom16"``: the standardised Binomial(16, 1/2),
  ``(popcount(16 random bits) - 8) / 2``: mean 0, variance 1, a 17-level
  lattice within 4 sigma.  PyTorch has no population count, so
  :func:`popcount16` counts the bits exactly with shifts and masks.
- ``noise_fused=True``: one draw per view over the labeled||unlabeled
  concatenation (4 draws instead of 8); same element distribution and
  independence between views.
"""

from __future__ import annotations

import torch


def popcount16(bits: torch.Tensor) -> torch.Tensor:
    """Exact population count of integers in [0, 2**16), by the SWAR
    method: sum adjacent 1-, 2-, 4- and 8-bit fields."""
    x = bits - ((bits >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x + (x >> 8)) & 0x1F


def make_noiser(noise_impl: str, scale: float):
    """Returns ``noisy(generator, a) -> a + scale * sample(a.shape)``,
    sampled in ``a.dtype`` on ``a.device``."""
    if noise_impl == "normal":
        def sample(g, a):
            return torch.randn(a.shape, generator=g, device=a.device,
                               dtype=a.dtype)
    elif noise_impl == "binom16":
        def sample(g, a):
            bits = torch.randint(0, 1 << 16, a.shape, generator=g,
                                 device=a.device, dtype=torch.int32)
            return (popcount16(bits).to(a.dtype) - 8) * 0.5
    else:
        raise ValueError(f"unknown noise_impl {noise_impl!r} "
                         "(want 'normal' or 'binom16')")

    def noisy(g, a):
        return a + sample(g, a) * scale

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
