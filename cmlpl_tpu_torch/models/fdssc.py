"""FDSSC, the Fast Dense Spectral-Spatial Convolution network
(``cmlpl_tpu/models/fdssc.py``; reference ``tools/conpared_models.py:
1165-1290``).

Two dense Conv3d blocks (the spectral (1,1,7) chain, then the spatial one
after the channel/depth permute), BN + PReLU, a global pool, Dropout(0.5)
and a linear head.  Layout (B, C, H, W, D), as in ``models/dbda.py``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cmlpl_tpu_torch.models.common import (BatchNorm, Dropout, F32Model,
                                           PReLU)

#: (name, channels) of the BN + PReLU stages, in call order; b4 is BN +
#: ReLU and has no PReLU
_STAGES = (("b1", 24), ("b2", 36), ("b3", 48), ("b4", 60), ("b5", 1),
           ("b6", 24), ("b7", 36), ("b8", 48), ("b9", 60))


class FDSSC(F32Model):
    def __init__(self, band: int, num_classes: int):
        super().__init__()
        spec = dict(kernel_size=(1, 1, 7), padding=(0, 0, 3))
        self.conv1 = nn.Conv3d(1, 24, (1, 1, 7), stride=(1, 1, 2))
        self.conv2 = nn.Conv3d(24, 12, **spec)
        self.conv3 = nn.Conv3d(36, 12, **spec)
        self.conv4 = nn.Conv3d(48, 12, **spec)
        self.conv5 = nn.Conv3d(60, 200, (1, 1, math.ceil((band - 6) / 2)))
        self.conv6 = nn.Conv3d(1, 24, (1, 1, 200))
        self.conv7 = nn.Conv3d(24, 12, **spec)
        self.conv8 = nn.Conv3d(36, 12, **spec)
        self.conv9 = nn.Conv3d(48, 12, **spec)
        for name, ch in _STAGES:
            self.add_module(f"{name}_bn", BatchNorm(ch, momentum=0.9,
                                                    eps=1e-3))
            if name != "b4":
                self.add_module(f"{name}_prelu", PReLU())
        self.drop = Dropout(0.5)
        self.head = nn.Linear(60, num_classes)

    def _stage(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return getattr(self, f"{name}_prelu")(getattr(self, f"{name}_bn")(x))

    def _forward(self, xp: torch.Tensor, generator=None) -> torch.Tensor:
        # dense spectral block
        x1 = self.conv1(xp[:, None])                       # (B, 24, H, W, D)
        x2 = self.conv2(self._stage(x1, "b1"))
        x3 = self.conv3(self._stage(torch.cat([x1, x2], 1), "b2"))
        x4 = self.conv4(self._stage(torch.cat([x1, x2, x3], 1), "b3"))
        x5 = torch.cat([x1, x2, x3, x4], 1)                # 60 channels
        x6 = self.conv5(F.relu(self.b4_bn(x5)))            # depth 1
        # permute (0,4,2,3,1): the 200 channels become the depth axis
        x6 = x6.permute(0, 4, 2, 3, 1)                     # (B, 1, H, W, 200)

        # dense spatial block
        x7 = self.conv6(self._stage(x6, "b5"))
        x8 = self.conv7(self._stage(x7, "b6"))
        x9 = self.conv8(self._stage(torch.cat([x7, x8], 1), "b7"))
        x10 = self.conv9(self._stage(torch.cat([x7, x8, x9], 1), "b8"))
        x10 = self._stage(torch.cat([x7, x8, x9, x10], 1), "b9")

        pooled = self.drop(x10.mean(dim=(2, 3, 4)), generator)
        return self.head(pooled)
