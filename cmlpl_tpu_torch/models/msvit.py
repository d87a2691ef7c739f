"""Multi-scale ViT with dual spatial-spectral attention
(``cmlpl_tpu/models/msvit.py``; reference ``tools/conpared_models.py:
1078-1512``).

A conv feature extractor (``OurFE``), one depthwise patch embedding and
transformer per patch size, attention that mixes spatial MHSA (a 3x3 conv
over the attention maps) with spectral attention over the transposed
tokens, a conv FeedForward, and a softmax-weighted fusion of the
branches' heads.  Layout NCHW; the token order is the flax model's (the
reference's transposed ``b c w h -> b (h w) c`` flatten), which the 3x3
conv over attention maps and the flattened heads depend on.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cmlpl_tpu_torch.models.common import BatchNorm, Dropout, F32Model


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) (conpared_models.py:1078-1083)."""
    return x * torch.tanh(F.softplus(x))


class DepthwiseConv(nn.Module):
    """DEPTHWISECONV (conpared_models.py:1363-1385): a depthwise conv,
    then a pointwise one unless ``is_fe``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1,
                 padding: int = 0, strides: int = 1, is_fe: bool = False):
        super().__init__()
        self.depth_conv = nn.Conv2d(in_ch, in_ch, kernel_size,
                                    stride=strides, padding=padding,
                                    groups=in_ch)
        self.is_fe = is_fe
        if not is_fe:
            self.point_conv = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.depth_conv(x)
        return x if self.is_fe else self.point_conv(x)


class OurFE(nn.Module):
    """Conv feature extractor (conpared_models.py:1299-1328)."""

    def __init__(self, channel: int):
        super().__init__()
        for name in ("c1", "c2", "c3"):
            self.add_module(f"{name}_conv", nn.Conv2d(channel, channel, 1))
            self.add_module(f"{name}_bn", BatchNorm(channel))
        self.out_conv = nn.Conv2d(3 * channel, channel, 3, padding=1)
        self.out_bn = BatchNorm(channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for name in ("c1", "c2", "c3"):
            x = F.relu(getattr(self, f"{name}_bn")(
                getattr(self, f"{name}_conv")(x)))
            outs.append(x)
        return F.relu(self.out_bn(self.out_conv(torch.cat(outs, 1))))


class DualAttention(nn.Module):
    """Spatial MHSA with conv-refined attention maps plus spectral
    attention over the transposed tokens (conpared_models.py:1388-1429)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 64,
                 dropout: float = 0.0, num_patches: int = 25):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.scale = dim_head ** -0.5
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.spatial_conv = nn.Conv2d(heads, heads, 3, padding=1)
        self.project_out = not (heads == 1 and dim_head == dim)
        if self.project_out:
            self.to_out = nn.Linear(inner, dim)
            self.drop = Dropout(dropout)
        self.to_qkv_spec = nn.Linear(num_patches, num_patches * 3,
                                     bias=False)
        self.spectral_conv = nn.Conv2d(1, 1, 3, padding=1)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        attn = torch.softmax((q @ k.transpose(-1, -2)) * self.scale, dim=-1)
        # the (B, heads, n, n) maps as NCHW: heads are the conv's channels
        attn = self.spatial_conv(attn)
        out = (attn @ v).transpose(1, 2).reshape(b, n, -1)
        if self.project_out:
            out = self.drop(self.to_out(out), generator)

        qs, ks, _ = self.to_qkv_spec(x.transpose(1, 2)).chunk(3, dim=-1)
        attn_s = torch.softmax((qs @ ks.transpose(1, 2)) * self.scale,
                               dim=-1)                     # (B, dim, dim)
        attn_s = self.spectral_conv(attn_s[:, None])[:, 0]
        return out @ attn_s


class ConvFeedForward(nn.Module):
    """FeedForward (conpared_models.py:1341-1360): depthwise conv + BN +
    two pointwise convs with GELU over the token grid, residual inside."""

    def __init__(self, dim: int):
        super().__init__()
        self.dw = DepthwiseConv(dim, 256, kernel_size=3, padding=1)
        self.bn = BatchNorm(256)
        self.pw1 = nn.Conv2d(256, 512, 1)
        self.pw2 = nn.Conv2d(512, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, n, dim)
        b, n, d = x.shape
        w = int(math.sqrt(n))
        h = x.transpose(1, 2).reshape(b, d, w, w)
        h = F.gelu(self.pw2(F.gelu(self.pw1(self.bn(self.dw(h))))))
        return x + h.reshape(b, d, n).transpose(1, 2)


class MSTransformer(nn.Module):
    """PreNorm transformer stack returning every layer's output
    (conpared_models.py:1432-1450)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 dropout: float = 0.0, num_patches: int = 25):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"ln_attn_{i}", nn.LayerNorm(dim))
            self.add_module(f"attn_{i}", DualAttention(
                dim, heads, dim_head, dropout, num_patches))
            self.add_module(f"ln_ff_{i}", nn.LayerNorm(dim))
            self.add_module(f"ff_{i}", ConvFeedForward(dim))

    def forward(self, x: torch.Tensor, generator=None):
        outputs = []
        for i in range(self.depth):
            attn = getattr(self, f"attn_{i}")
            x = attn(getattr(self, f"ln_attn_{i}")(x), generator) + x
            x = getattr(self, f"ff_{i}")(getattr(self, f"ln_ff_{i}")(x)) + x
            outputs.append(x)
        return x, outputs


def get_num_patches(image_size: int, patch_size: int) -> int:
    """(conpared_models.py:1466-1467)"""
    return int((image_size - patch_size) / patch_size) + 1


class MultiScaleViT(F32Model):
    """The zoo's multi-branch ViT (conpared_models.py:1470-1512).

    Input: (B, w, w, channels) patch.  Each patch size has its own
    embedding, transformer and head (``LayerNorm_<i>``, ``Dense_<i>``, as
    flax names them); the heads are fused by a softmax over learnable
    branch weights (ones at init: a uniform fusion)."""

    def __init__(self, image_size: int, patch_sizes: Sequence[int],
                 num_classes: int, dim: int, depth: int, heads: int,
                 channels: int = 3, dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0):
        super().__init__()
        self.patch_sizes = tuple(patch_sizes)
        self.ournet = OurFE(channels)
        self.conv4 = nn.Conv2d(channels, dim, 1)
        self.emb_drop = Dropout(emb_dropout)
        for bi, ps in enumerate(self.patch_sizes):
            n = get_num_patches(image_size, ps) ** 2
            self.add_module(f"embed_{bi}", DepthwiseConv(
                dim, dim, kernel_size=ps, strides=ps, is_fe=True))
            self.register_parameter(f"pos_embedding_{bi}", nn.Parameter(
                torch.zeros(1, n + 1, dim)))
            self.add_module(f"transformer_{bi}", MSTransformer(
                dim, depth, heads, dim_head, dropout, n))
            self.add_module(f"LayerNorm_{bi}", nn.LayerNorm(n * dim))
            self.add_module(f"Dense_{bi}", nn.Linear(n * dim, num_classes))
        self.branch_weight = nn.Parameter(torch.ones(len(self.patch_sizes)))

    def _forward(self, xp: torch.Tensor, generator=None) -> torch.Tensor:
        img = self.ournet(xp.permute(0, 3, 1, 2))
        # contiguous: on the card (torch 2.11, CUDA 12.8) the backward of
        # this padded average pool over a channels-last f32 tensor, which
        # cuDNN's convolutions return for the channels-last patch, is wrong
        # (0.99 of the gradient's largest entry off)
        img = self.conv4(F.avg_pool2d(img.contiguous(), 3, stride=1,
                                      padding=1, count_include_pad=True))
        logits = []
        for bi in range(len(self.patch_sizes)):
            h = getattr(self, f"embed_{bi}")(img)          # (B, d, hh, ww)
            b, d = h.shape[:2]
            # the flax model's token order: the last spatial dim outer
            tokens = h.permute(0, 3, 2, 1).reshape(b, -1, d)
            pos = getattr(self, f"pos_embedding_{bi}")
            tokens = self.emb_drop(tokens + pos[:, :tokens.shape[1]],
                                   generator)
            _, outputs = getattr(self, f"transformer_{bi}")(tokens,
                                                            generator)
            res = getattr(self, f"LayerNorm_{bi}")(outputs[-1].reshape(b, -1))
            logits.append(getattr(self, f"Dense_{bi}")(res))
        weight = torch.softmax(self.branch_weight, dim=0)
        return sum(w * lg for w, lg in zip(weight, logits))
