"""DBDA, the Double-Branch Dual-Attention network
(``cmlpl_tpu/models/dbda.py``; reference ``tools/conpared_models.py:
719-1077``): :class:`DBDAFeature` (the first definition, with a 64-d
l2-normalised feature head, returns ``(logits, feature)``) and
:class:`DBDA` (the shadowing one, a plain logits head).

Layout: the patch (B, w, w, band) becomes (B, 1, H, W, band), the
reference's NCDHW with the spectral axis as the last conv dim; a flax
kernel (kh, kw, kd, in, out) is this Conv3d's (out, in, kh, kw, kd).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cmlpl_tpu_torch.models.attention import CAMModule, PAMModule
from cmlpl_tpu_torch.models.common import BatchNorm, F32Model, l2_normalize


def _bn(ch: int) -> BatchNorm:
    return BatchNorm(ch, momentum=0.9, eps=1e-3)


class _DBDATrunk(nn.Module):
    """The spectral and spatial dense branches with CAM/PAM attention;
    returns the pooled (B, 120) concat."""

    def __init__(self, band: int):
        super().__init__()
        spec = dict(kernel_size=(1, 1, 7), padding=(0, 0, 3))
        self.conv11 = nn.Conv3d(1, 24, (1, 1, 7), stride=(1, 1, 2))
        self.conv12 = nn.Conv3d(24, 24, **spec)
        self.conv13 = nn.Conv3d(48, 24, **spec)
        self.conv14 = nn.Conv3d(72, 24, **spec)
        self.conv15 = nn.Conv3d(96, 60, (1, 1, math.floor((band - 6) / 2)))
        for name, ch in (("bn11", 24), ("bn12", 48), ("bn13", 72),
                         ("bn14", 96), ("bn21", 24), ("bn22", 36),
                         ("bn23", 48)):
            self.add_module(name, _bn(ch))
        self.attention_spectral = CAMModule(60)
        spat = dict(kernel_size=(3, 3, 1), padding=(1, 1, 0))
        self.conv21 = nn.Conv3d(1, 24, (1, 1, band))
        self.conv22 = nn.Conv3d(24, 12, **spat)
        self.conv23 = nn.Conv3d(36, 12, **spat)
        self.conv24 = nn.Conv3d(48, 12, **spat)
        self.attention_spatial = PAMModule(60)

    def forward(self, xp: torch.Tensor) -> torch.Tensor:
        x00 = xp[:, None]                                   # (B, 1, H, W, D)

        def dense(x, bn, conv):
            return conv(F.relu(bn(x)))

        # spectral branch: dense (1,1,7) chain, growth 24
        x11 = self.conv11(x00)
        x12 = dense(x11, self.bn11, self.conv12)
        x13 = dense(torch.cat([x11, x12], 1), self.bn12, self.conv13)
        x14 = dense(torch.cat([x11, x12, x13], 1), self.bn13, self.conv14)
        x16 = dense(torch.cat([x11, x12, x13, x14], 1), self.bn14,
                    self.conv15)
        x1 = self.attention_spectral(x16) * x16

        # spatial branch: dense (3,3,1) chain; depth 1 after conv21
        x21 = self.conv21(x00)
        x22 = dense(x21, self.bn21, self.conv22)
        x23 = dense(torch.cat([x21, x22], 1), self.bn22, self.conv23)
        x24 = dense(torch.cat([x21, x22, x23], 1), self.bn23, self.conv24)
        x25 = torch.cat([x21, x22, x23, x24], 1)[..., 0]   # (B, 60, H, W)
        x2 = self.attention_spatial(x25) * x25

        return torch.cat([x1.mean(dim=(2, 3, 4)), x2.mean(dim=(2, 3))], 1)


class DBDAFeature(F32Model):
    """First DBDA definition (conpared_models.py:719-900): 64-d l2 feature
    head and a 64 -> 64 -> 32 -> classes MLP; returns (logits, feature)."""

    def __init__(self, band: int, num_classes: int):
        super().__init__()
        self.trunk = _DBDATrunk(band)
        self.feature_out = nn.Linear(120, 64)
        self.fc1 = nn.Linear(64, 64)
        self.fc2 = nn.Linear(64, 32)
        self.fc3 = nn.Linear(32, num_classes)

    def _forward(self, xp: torch.Tensor, generator=None):
        feature = l2_normalize(self.feature_out(self.trunk(xp)))
        return self.fc3(self.fc2(self.fc1(feature))), feature


class DBDA(F32Model):
    """Shadowing DBDA definition (conpared_models.py:903-1077): a direct
    120 -> classes head."""

    def __init__(self, band: int, num_classes: int):
        super().__init__()
        self.trunk = _DBDATrunk(band)
        self.full_connection = nn.Linear(120, num_classes)

    def _forward(self, xp: torch.Tensor, generator=None) -> torch.Tensor:
        return self.full_connection(self.trunk(xp))
