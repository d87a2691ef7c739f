"""SSFTTnet, the Spectral-Spatial Former (``cmlpl_tpu/models/ssftt.py``;
reference ``tools/conpared_models.py:128-190``) and its single-layer ViT
(``:23-112``).

Conv3d(1 -> 8, k 3) over (spectral, H, W), the (8 x depth) maps merged into
2-D channels, Conv2d(-> 64, k 3), learned tokenisation (``token_wA`` /
``token_wV``), one transformer layer, and the head on the cls token.
Dropout layers take their masks from the ``generator`` passed to
``forward``, in the flax model's call order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cmlpl_tpu_torch.models.common import BatchNorm, Dropout, F32Model


class ViTAttention(nn.Module):
    """MHSA with fused qkv (conpared_models.py:57-95), scaled by
    ``dim ** -0.5`` (the full dim, as the reference)."""

    def __init__(self, dim: int, heads: int = 8, dropout: float = 0.1):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.to_qkv = nn.Linear(dim, dim * 3)
        self.nn1 = nn.Linear(dim, dim)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = (t.reshape(b, n, self.heads, d // self.heads)
                   .transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        attn = torch.softmax((q @ k.transpose(-1, -2)) * self.dim ** -0.5,
                             dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, d)
        return self.drop(self.nn1(out), generator)


class ViTMLP(nn.Module):
    """MLP_Block (conpared_models.py:42-54); exact-erf GELU."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.1):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, dim)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        h = self.drop(F.gelu(self.Dense_0(x)), generator)
        return self.drop(self.Dense_1(h), generator)


class ViTTransformer(nn.Module):
    """Residual(LayerNorm(Attention)) + Residual(LayerNorm(MLP)) stack
    (conpared_models.py:98-112)."""

    def __init__(self, dim: int, depth: int, heads: int, mlp_dim: int,
                 dropout: float = 0.1):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"ln_attn_{i}", nn.LayerNorm(dim))
            self.add_module(f"attn_{i}", ViTAttention(dim, heads, dropout))
            self.add_module(f"ln_mlp_{i}", nn.LayerNorm(dim))
            self.add_module(f"mlp_{i}", ViTMLP(dim, mlp_dim, dropout))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        for i in range(self.depth):
            layer = getattr(self, f"attn_{i}")
            x = x + layer(getattr(self, f"ln_attn_{i}")(x), generator)
            layer = getattr(self, f"mlp_{i}")
            x = x + layer(getattr(self, f"ln_mlp_{i}")(x), generator)
        return x


class SSFTTnet(F32Model):
    """Input: (B, w, w, n_pc) PCA patch, NHWC.  The Conv3d runs over
    (spectral, H, W) with the spectral axis as depth; ``8 * (n_pc - 2)``
    is the Conv2d's input width (24 at the zoo's n_pc 5)."""

    def __init__(self, num_classes: int = 9, n_pc: int = 5,
                 num_tokens: int = 4, dim: int = 64, depth: int = 1,
                 heads: int = 8, mlp_dim: int = 8, dropout: float = 0.1,
                 emb_dropout: float = 0.1):
        super().__init__()
        self.dim = dim
        self.conv3d = nn.Conv3d(1, 8, 3)
        self.bn3d = BatchNorm(8)
        self.conv2d = nn.Conv2d(8 * (n_pc - 2), 64, 3)
        self.bn2d = BatchNorm(64)
        self.token_wA = nn.Parameter(torch.zeros(1, num_tokens, 64))
        self.token_wV = nn.Parameter(torch.zeros(1, 64, dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, num_tokens + 1,
                                                      dim))
        self.emb_drop = Dropout(emb_dropout)
        self.transformer = ViTTransformer(dim, depth, heads, mlp_dim,
                                          dropout)
        self.head = nn.Linear(dim, num_classes)

    def _forward(self, xp: torch.Tensor, generator=None) -> torch.Tensor:
        b = xp.shape[0]
        # (B, 1, D = n_pc, H, W)
        x = F.relu(self.bn3d(self.conv3d(xp.permute(0, 3, 1, 2)[:, None])))
        # flax's merge: 2-D channel d * 8 + c of (depth d, channel c)
        _, c8, d2, h2, w2 = x.shape
        x = x.transpose(1, 2).reshape(b, d2 * c8, h2, w2)
        x = F.relu(self.bn2d(self.conv2d(x)))
        tokens = x.flatten(2).transpose(1, 2)              # (B, n, 64)
        a = torch.softmax((tokens @ self.token_wA[0].T).transpose(1, 2),
                          dim=-1)                          # (B, L, n)
        t = a @ (tokens @ self.token_wV[0])                # (B, L, dim)
        z = torch.cat([self.cls_token.expand(b, 1, self.dim), t], dim=1)
        z = self.emb_drop(z + self.pos_embedding, generator)
        z = self.transformer(z, generator)
        return self.head(z[:, 0])
