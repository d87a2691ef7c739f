"""Position and channel attention (``cmlpl_tpu/models/attention.py``;
reference ``tools/conpared_models.py:620-707``).

Layout: channels first, as the rest of the port's zoo.  PAM takes NCHW;
CAM takes (B, C, ...) and attends over the channels, with every other
position a sample of the gram matrix.  Each output is ``gamma * out + x``
with ``gamma`` 0 at init.
"""

from __future__ import annotations

import torch
from torch import nn


class PAMModule(nn.Module):
    """Position (spatial) attention, SAGAN-style (conpared_models.py:
    620-672): 1x1 conv q/k/v, softmax over the HW x HW affinity."""

    def __init__(self, in_dim: int):
        super().__init__()
        inner = max(in_dim // 8, 1)
        self.query_conv = nn.Conv2d(in_dim, inner, 1)
        self.key_conv = nn.Conv2d(in_dim, inner, 1)
        self.value_conv = nn.Conv2d(in_dim, in_dim, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, H, W)
        b, c, h, w = x.shape
        q = self.query_conv(x).flatten(2).transpose(1, 2)   # (B, HW, C/8)
        k = self.key_conv(x).flatten(2)                     # (B, C/8, HW)
        v = self.value_conv(x).flatten(2)                   # (B, C, HW)
        attn = torch.softmax(q @ k, dim=-1)                 # (B, HW, HW)
        out = (v @ attn.transpose(1, 2)).reshape(b, c, h, w)
        return self.gamma * out + x


class CAMModule(nn.Module):
    """Channel attention (conpared_models.py:675-707): the channels' gram
    matrix with the max-energy trick."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, ...)
        flat = x.flatten(2)                                 # (B, C, N)
        energy = flat @ flat.transpose(1, 2)                # (B, C, C)
        energy = energy.amax(dim=-1, keepdim=True) - energy
        attn = torch.softmax(energy, dim=-1)
        out = (attn @ flat).reshape(x.shape)
        return self.gamma * out + x
