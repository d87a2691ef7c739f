"""BaseNet2, the CMLPL backbone (reference ``tools/models.py:97-152``;
JAX counterpart ``cmlpl_tpu/models/basenet.py:34-76``).

The public input is NHWC ``(B, w, w, n_pc)`` as in the JAX package.  The
patch is viewed as NCHW with channels-last strides for cuDNN, and the
spatial flatten runs in (H, W, C) order like the flax model, so weights
carried over from JAX (:mod:`cmlpl_tpu_torch.weights`) line up with the
classifier's rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cmlpl_tpu_torch.device import set_compute_precision
from cmlpl_tpu_torch.models.common import avg_pool2, l2_normalize

FEAT_DIM = 1024       # spectral feature width (models.py:119)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class BaseNet2(nn.Module):
    """Dual-branch spectral-spatial CNN.

    Inputs: ``xp`` (B, w, w, n_pc) PCA patch (NHWC), ``x`` (B, bands)
    spectrum.  Returns (logits, l2-normalised spectral feature), both f32.

    ``compute_dtype``: dtype the conv/dense layers compute in; params stay
    f32 and are cast per call, as flax's ``dtype`` does.  Constructing the
    model sets the TF32 switches from it (``set_compute_precision``).
    """

    def __init__(self, num_features: int = 103, dropout: float = 0.0,
                 num_classes: int = 9, n_pc: int = 60, patch_size: int = 20,
                 compute_dtype: str = "float32"):
        super().__init__()
        set_compute_precision(compute_dtype)
        self.compute_dtype = _DTYPES[compute_dtype]
        self.dropout = dropout
        self.conv0 = nn.Conv2d(n_pc, 64, 1)
        self.conv1 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv2 = nn.Conv2d(64, 64, 3, padding=1)
        self.feat_spe = nn.Linear(num_features, FEAT_DIM)
        spatial = 64 * (patch_size // 4) ** 2
        self.classifier = nn.Linear(spatial + FEAT_DIM, num_classes)

    def _conv(self, layer: nn.Conv2d, h: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(h, layer.weight.to(dt), layer.bias.to(dt),
                        padding=layer.padding)

    def _dense(self, layer: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(h, layer.weight.to(dt), layer.bias.to(dt))

    def forward(self, xp: torch.Tensor, x: torch.Tensor,
                generator: torch.Generator | None = None):
        """In training mode the dropout mask is drawn from ``generator``
        (torch's default generator when None)."""
        dt = self.compute_dtype
        h = xp.to(dt).permute(0, 3, 1, 2)   # NCHW view, channels-last strides
        h = self._conv(self.conv0, h)
        res = h
        h = F.relu(self._conv(self.conv1, h) + res)
        h = avg_pool2(h)
        res = h
        h = F.relu(self._conv(self.conv2, h) + res)
        h = avg_pool2(h)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # (H, W, C) order

        y = F.relu(self._dense(self.feat_spe, x.to(dt)))
        z = torch.cat([h, y], dim=1)
        feat = l2_normalize(y.float())
        if self.dropout > 0 and self.training:
            z = dropout(z, self.dropout, generator)
        logits = self._dense(self.classifier, z)
        return logits.float(), feat


def dropout(z: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """Flax's ``nn.Dropout``: keep each element with probability
    ``1 - rate`` (a uniform draw below it) and scale the kept ones by
    ``1 / (1 - rate)``."""
    keep = 1.0 - rate
    if keep <= 0.0:
        return torch.zeros_like(z)
    mask = torch.rand(z.shape, generator=generator, device=z.device) < keep
    return torch.where(mask, z / keep, torch.zeros((), dtype=z.dtype,
                                                   device=z.device))
