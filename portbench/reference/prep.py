"""Scene preparation (``tools/hyper_tools.py:8-55,246-297``): z-scored
PCA features, mirror-padded for patches, and z-scored spectra."""

from __future__ import annotations

import numpy as np
import torch


def zscore(x: np.ndarray) -> np.ndarray:
    """Per-column z-score (``featureNormalize``, type 1)."""
    xc = x - np.mean(x, 0)
    return xc / np.std(xc, 0)


def pca(x: np.ndarray, n_pc: int) -> np.ndarray:
    """Projection of the centred pixels on the leading ``n_pc`` left
    singular vectors of their (N-1)-normalised covariance (``PCANorm``)."""
    xc = x - np.mean(x, 0)
    u, _, _ = np.linalg.svd(np.cov(xc.T))
    return np.dot(xc, u[:, :n_pc])


def prepare(cube: np.ndarray, n_pc: int, patch_size: int, device):
    """(padded (rows + 2h, cols + 2h, n_pc) f32, spectra (rows*cols,
    bands) f32) on ``device``, h = w // 2 for even w, (w - 1) // 2 for odd
    (``MirrowCut``: a symmetric pad that repeats the edge)."""
    rows, cols, bands = cube.shape
    flat = cube.reshape(rows * cols, bands)
    feats = zscore(pca(flat, n_pc)).reshape(rows, cols, n_pc)
    h = patch_size // 2 if patch_size % 2 == 0 else (patch_size - 1) // 2
    padded = np.pad(feats.astype(np.float32), ((h, h), (h, h), (0, 0)),
                    mode="symmetric")
    return (torch.from_numpy(np.ascontiguousarray(padded)).to(device),
            torch.from_numpy(zscore(flat).astype(np.float32)).to(device))


def patches(padded: torch.Tensor, ids: torch.Tensor, cols: int,
            w: int) -> torch.Tensor:
    """(B, w, w, C) patches of the flat pixel ids: pixel (r, c)'s patch is
    ``padded[r:r + w, c:c + w]``."""
    win = padded.unfold(0, w, 1).unfold(1, w, 1)      # (H', W', C, w, w)
    ids = ids.long()
    return win[ids // cols, ids % cols].permute(0, 2, 3, 1)
