"""BaseNet2 (``tools/models.py:97-152``), the dual-branch network of
CMLPL: on the (B, w, w, n_pc) PCA patch, a 1x1 convolution to 64
channels, two 3x3 residual convolutions each followed by a 2x2 average
pool, flattened in (H, W, C) order; on the (B, bands) spectrum a dense
layer to 1,024 and a ReLU; the concatenation, dropout and a linear
classifier.  The second output is the spectral feature, l2-normalised.

Parameters are a dict in torch's layout: ``conv0``, ``conv1``, ``conv2``,
``feat_spe``, ``classifier``, each ``.weight`` and ``.bias``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

FEAT_DIM = 1024


def shapes(n_pc: int, bands: int, classes: int, patch_size: int) -> dict:
    """name -> shape of every parameter."""
    joint = 64 * (patch_size // 4) ** 2 + FEAT_DIM
    return {"conv0.weight": (64, n_pc, 1, 1), "conv0.bias": (64,),
            "conv1.weight": (64, 64, 3, 3), "conv1.bias": (64,),
            "conv2.weight": (64, 64, 3, 3), "conv2.bias": (64,),
            "feat_spe.weight": (FEAT_DIM, bands), "feat_spe.bias": (FEAT_DIM,),
            "classifier.weight": (classes, joint),
            "classifier.bias": (classes,)}


def forward(p: dict, xp: torch.Tensor, x: torch.Tensor,
            keep: torch.Tensor | None = None, rate: float = 0.0):
    """(logits, l2-normalised spectral feature).  ``keep``: the dropout
    mask of the joint feature (kept elements scaled by 1 / (1 - rate)),
    or None in evaluation."""
    h = xp.permute(0, 3, 1, 2)
    h = F.conv2d(h, p["conv0.weight"], p["conv0.bias"])
    h = F.avg_pool2d(F.relu(F.conv2d(h, p["conv1.weight"], p["conv1.bias"],
                                     padding=1) + h), 2)
    h = F.avg_pool2d(F.relu(F.conv2d(h, p["conv2.weight"], p["conv2.bias"],
                                     padding=1) + h), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    y = F.relu(F.linear(x, p["feat_spe.weight"], p["feat_spe.bias"]))
    z = torch.cat([h, y], dim=1)
    feat = y / torch.sqrt(torch.sum(y * y, dim=1, keepdim=True))
    if keep is not None:
        z = torch.where(keep, z / (1.0 - rate), torch.zeros_like(z))
    return F.linear(z, p["classifier.weight"], p["classifier.bias"]), feat
