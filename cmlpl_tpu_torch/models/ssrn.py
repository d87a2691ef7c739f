"""SSRN, the Spectral-Spatial Residual Network (``cmlpl_tpu/models/ssrn.py``;
reference ``tools/conpared_models.py:1086-1163``).

A Conv3d stem over the spectral axis, two spectral residual blocks, a
spectral-collapse conv whose 128 output channels become the depth axis of
the spatial stage, two spatial residual blocks, a pooled linear head.
Layout (B, C, H, W, D), as in ``models/dbda.py``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cmlpl_tpu_torch.models.common import BatchNorm, F32Model


class Residual3D(nn.Module):
    """3-D residual block (conpared_models.py:1086-1108): conv1, ReLU, BN,
    ReLU (the reference's ``conv1`` carries its own ReLU), conv2, BN, then
    ReLU of the sum with the input; flax's BN defaults."""

    def __init__(self, channels: int, kernel: tuple, padding: tuple):
        super().__init__()
        self.conv1 = nn.Conv3d(channels, channels, kernel, padding=padding)
        self.bn1 = BatchNorm(channels)
        self.conv2 = nn.Conv3d(channels, channels, kernel, padding=padding)
        self.bn2 = BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(F.relu(self.conv1(x))))
        return F.relu(self.bn2(self.conv2(y)) + x)


class SSRN(F32Model):
    def __init__(self, band: int, num_classes: int):
        super().__init__()
        self.conv1 = nn.Conv3d(1, 24, (1, 1, 7), stride=(1, 1, 2))
        self.bn1 = BatchNorm(24, momentum=0.9, eps=1e-3)
        self.res1 = Residual3D(24, (1, 1, 7), (0, 0, 3))
        self.res2 = Residual3D(24, (1, 1, 7), (0, 0, 3))
        self.conv2 = nn.Conv3d(24, 128, (1, 1, math.ceil((band - 6) / 2)))
        self.bn2 = BatchNorm(128, momentum=0.9, eps=1e-3)
        self.conv3 = nn.Conv3d(1, 24, (3, 3, 128))
        self.bn3 = BatchNorm(24, momentum=0.9, eps=1e-3)
        self.res3 = Residual3D(24, (3, 3, 1), (1, 1, 0))
        self.res4 = Residual3D(24, (3, 3, 1), (1, 1, 0))
        self.head = nn.Linear(24, num_classes)

    def _forward(self, xp: torch.Tensor, generator=None) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(xp[:, None])))     # (B, 24, H, W, D)
        x = self.res2(self.res1(x))
        x = F.relu(self.bn2(self.conv2(x)))                # depth 1
        # torch permute(0,4,2,3,1): the 128 channels become the depth axis
        x = x.permute(0, 4, 2, 3, 1)                       # (B, 1, H, W, 128)
        x = F.relu(self.bn3(self.conv3(x)))
        x = self.res4(self.res3(x))
        x = F.avg_pool3d(x, (5, 5, 1), stride=(5, 5, 1))
        # flax flattens (H, W, D, C)
        return self.head(x.permute(0, 2, 3, 4, 1).flatten(1))
