"""Windowed patch gather: the CUDA kernels, their wrappers and the plain
PyTorch version they are held against.

For flat pixel ids ``idx`` (B,) int32 over a scene of ``cols`` columns,
every function here returns

    out[b] = cube[r:r+w, c:c+w, :],   r = idx[b] // cols,  c = idx[b] % cols

as a contiguous (B, w, w, C) tensor of the cube's dtype, with the start
clamped into the cube the way ``lax.dynamic_slice`` clamps it (the
contract of ``cmlpl_tpu.data.patches.gather_patches``).

Kernel 1, :func:`gather_patches_f32`, replaces the Pallas TPU kernel
``cmlpl_tpu/ops/patch_gather.py::gather_patches_pallas`` (f32).  Kernel 2,
:func:`gather_patches_bf16`, replaces ``gather_patches_pallas_shifted``
(bf16) and reads a plain bf16 cube (``padded.to(torch.bfloat16)``) where
the TPU kernel needed eight column-shifted copies.  Both are one templated
CUDA kernel in ``csrc/patch_gather.cu``; its header says what bounds it
(bytes: the (B, w, w, C) output is written once, the overlapping window
reads mostly hit L2) and what its design does about it.

A wrapper given CPU tensors runs the plain version,
:func:`cmlpl_tpu_torch.data.patches.gather_patches`.  Given CUDA
tensors it launches its kernel or raises: it never falls back to the plain
version.  ``<wrapper>.launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from cmlpl_tpu_torch.data.patches import gather_patches as gather_patches_plain
from cmlpl_tpu_torch.ops import _build


def _check(cube: torch.Tensor, idx: torch.Tensor, cols: int, w: int,
           dtype: torch.dtype) -> None:
    if cube.dtype != dtype:
        raise TypeError(f"cube must be {dtype}, got {cube.dtype}")
    if cube.dim() != 3:
        raise ValueError(f"cube must be (rows, cols, C), got {cube.shape}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError(f"idx must be a 1-D int32 tensor, got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if idx.device != cube.device:
        raise ValueError(f"idx on {idx.device}, cube on {cube.device}")
    if not (0 < w <= min(cube.shape[0], cube.shape[1])):
        raise ValueError(f"window {w} does not fit cube {tuple(cube.shape)}")
    if cols <= 0:
        raise ValueError(f"cols must be positive, got {cols}")


def _launch(fn_name: str, cube: torch.Tensor, idx: torch.Tensor, cols: int,
            w: int) -> torch.Tensor:
    if not cube.is_contiguous() or not idx.is_contiguous():
        raise ValueError("cube and idx must be contiguous")
    b = idx.shape[0]
    if max(*cube.shape, b * w) >= 2 ** 31:
        raise ValueError(f"cube {tuple(cube.shape)} or {b} patches of {w} "
                         "rows exceed the kernel's 32-bit dims and grid")
    out = torch.empty((b, w, w, cube.shape[-1]), dtype=cube.dtype,
                      device=cube.device)
    fn = getattr(_build.library(), fn_name)
    with torch.cuda.device(cube.device):
        stream = torch.cuda.current_stream(cube.device).cuda_stream
        err = fn(cube.data_ptr(), idx.data_ptr(), out.data_ptr(), b,
                 cube.shape[0], cube.shape[1], cube.shape[2], cols, w,
                 stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError_t {err}")
    return out


def gather_patches_f32(padded: torch.Tensor, idx: torch.Tensor, *,
                       cols: int, w: int) -> torch.Tensor:
    """Kernel 1: (B, w, w, C) f32 patches from the f32 padded cube
    (replaces ``gather_patches_pallas``, ``cmlpl_tpu/ops/patch_gather.py``
    ``:63-109``)."""
    _check(padded, idx, cols, w, torch.float32)
    if padded.device.type == "cpu":
        return gather_patches_plain(padded, idx, cols=cols, w=w)
    if padded.device.type != "cuda":
        raise ValueError(f"unsupported device {padded.device}")
    out = _launch("cmlpl_patch_gather_f32", padded, idx, cols, w)
    gather_patches_f32.launches += 1
    return out


def gather_patches_bf16(cube: torch.Tensor, idx: torch.Tensor, *,
                        cols: int, w: int) -> torch.Tensor:
    """Kernel 2: (B, w, w, C) bf16 patches from a plain bf16 cube
    (replaces ``gather_patches_pallas_shifted`` and its shift cube,
    ``cmlpl_tpu/ops/patch_gather.py:159-222``).  Callers upcast
    ``[..., :n_pc]`` to f32, as the JAX callers do."""
    _check(cube, idx, cols, w, torch.bfloat16)
    if cube.device.type == "cpu":
        return gather_patches_plain(cube, idx, cols=cols, w=w)
    if cube.device.type != "cuda":
        raise ValueError(f"unsupported device {cube.device}")
    out = _launch("cmlpl_patch_gather_bf16", cube, idx, cols, w)
    gather_patches_bf16.launches += 1
    return out


gather_patches_f32.launches = 0
gather_patches_bf16.launches = 0

#: every kernel wrapper of the port, for resetting and reading the counts
WRAPPERS = (gather_patches_f32, gather_patches_bf16)
