"""Patch geometry and the plain PyTorch patch gather.

For pixel ``k`` at (r, c) = (k // cols, k % cols) the patch is

    padded[r : r + w,  c : c + w,  :]

where ``padded`` is the scene symmetric-padded by ``patch_pad_width(w)``
on each side (the geometry of ``cmlpl_tpu/data/patches.py``, reference
``hyper_tools.py:226-243``).  The gather runs over the device-resident
padded cube, so the full (K, w, w, n_pc) patch tensor never exists.

:func:`gather_patches` is the plain version of the CUDA patch-gather
kernels in :mod:`cmlpl_tpu_torch.ops.patch_gather`: they are held
bitwise equal to it.
"""

from __future__ import annotations

import numpy as np
import torch


def patch_pad_width(w: int) -> int:
    """Mirror-pad halfwidth for patch size w (reference hyper_tools.py:227,
    :301)."""
    return w // 2 if w % 2 == 0 else (w - 1) // 2


def pad_symmetric(x: np.ndarray, hw: int) -> np.ndarray:
    """Symmetric (edge-inclusive reflect) pad of the two leading spatial
    dims (the reference's ``MirrowCut``, ``hyper_tools.py:35-55``)."""
    return np.pad(x, ((hw, hw), (hw, hw), (0, 0)), mode="symmetric")


def clamped_starts(idx: torch.Tensor, cols: int, cube_rows: int,
                   cube_cols: int, w: int):
    """Top-left window corner (r, c) per pixel id, as ``lax.dynamic_slice``
    takes its start: ids are floor-divided (JAX's ``//`` on int32), a
    negative start counts from the end of its axis, and the start is then
    clamped so the window lies in the cube."""
    idx = idx.long()
    r, c = idx // cols, idx % cols
    r = torch.where(r < 0, r + cube_rows, r)
    c = torch.where(c < 0, c + cube_cols, c)
    return (torch.clamp(r, 0, cube_rows - w),
            torch.clamp(c, 0, cube_cols - w))


def gather_patches(padded: torch.Tensor, idx: torch.Tensor, *, cols: int,
                   w: int) -> torch.Tensor:
    """(B, w, w, C) patches for flat pixel ids (B,): broadcast window
    indices and one advanced index."""
    r, c = clamped_starts(idx, cols, padded.shape[0], padded.shape[1], w)
    off = torch.arange(w, device=padded.device)
    rows = (r[:, None] + off)[:, :, None]   # (B, w, 1)
    cols_ = (c[:, None] + off)[:, None, :]  # (B, 1, w)
    return padded[rows, cols_]


def gather_spectra(spectra: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, bands) z-scored spectra rows for flat pixel ids."""
    return spectra.index_select(0, idx)
