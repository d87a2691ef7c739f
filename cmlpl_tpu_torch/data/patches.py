"""Patch geometry and the plain PyTorch patch gather.

For pixel ``k`` at (r, c) = (k // cols, k % cols) the patch is

    padded[r : r + w,  c : c + w,  :]

where ``padded`` is the scene symmetric-padded by ``patch_pad_width(w)``
on each side (the geometry of ``cmlpl_tpu/data/patches.py``, reference
``hyper_tools.py:226-243``).  The gather runs over the device-resident
padded cube, so the full (K, w, w, n_pc) patch tensor never exists, but
for :func:`extract_patches`, which writes it on the host, chunk by chunk,
for the reference's ``XP.npy`` (``cli.sample_generation
--materialize_patches``).

:func:`gather_patches` is the plain version of the CUDA patch-gather
kernels in :mod:`cmlpl_tpu_torch.ops.patch_gather`: they are held
bitwise equal to it.
"""

from __future__ import annotations

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

#: host bytes of patches one chunk of :func:`extract_patches` copies
CHUNK_BYTES = 256 << 20


def patch_pad_width(w: int) -> int:
    """Mirror-pad halfwidth for patch size w (reference hyper_tools.py:227,
    :301)."""
    return w // 2 if w % 2 == 0 else (w - 1) // 2


def pad_symmetric(x: np.ndarray, hw: int) -> np.ndarray:
    """Symmetric (edge-inclusive reflect) pad of the two leading spatial
    dims (the reference's ``MirrowCut``, ``hyper_tools.py:35-55``)."""
    return np.pad(x, ((hw, hw), (hw, hw), (0, 0)), mode="symmetric")


def chunk_rows(cols: int, channels: int, w: int,
               chunk_bytes: int = CHUNK_BYTES) -> int:
    """Scene rows a chunk of :func:`extract_patches` takes: as many whole
    rows of f32 patches as fit ``chunk_bytes``, at least one."""
    return max(1, chunk_bytes // (cols * channels * w * w * 4))


def extract_patches(padded: np.ndarray, rows: int, cols: int, w: int,
                    out=None, chunk_bytes: int = CHUNK_BYTES) -> np.ndarray:
    """Every pixel's patch of the padded cube ``padded`` (rows + 2 hw,
    cols + 2 hw, C), pixel k = r * cols + c taking ``padded[r:r+w,
    c:c+w]``, in the reference's NCHW layout (rows * cols, C, w, w) f32
    (``hyper_tools.py:226-243``): the host extraction that the JAX
    package's ``native/patch_ops.cpp`` does.  Written into ``out`` (for
    example a ``np.lib.format.open_memmap``; a new array when None) a
    chunk of :func:`chunk_rows` scene rows at a time, so no more than
    ``chunk_bytes`` of patches is copied at once.  At an even ``w`` the
    window runs from w/2 above the pixel to w/2 - 1 below it, as
    :func:`patch_pad_width` pads."""
    channels = padded.shape[-1]
    if out is None:
        out = np.empty((rows * cols, channels, w, w), np.float32)
    # (rows, cols, C, w, w): a view, nothing copied yet
    win = sliding_window_view(padded, (w, w), axis=(0, 1))[:rows, :cols]
    step = chunk_rows(cols, channels, w, chunk_bytes)
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        out[r0 * cols:r1 * cols] = win[r0:r1].reshape(-1, channels, w, w)
    return out


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
