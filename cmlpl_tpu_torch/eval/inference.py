"""Full-scene inference: the tiled map of ``cmlpl_tpu/eval/inference.py``
(``ScenePredictor``, ``:144-249,328-364``) on PyTorch.

Pixel ids are cut into tiles of ``tile`` pixels; each tile gathers its
patches from the device-resident padded cube, runs the forward pass and
argmaxes on the device.  The predictions stay on the device until one
final (K,) int32 copy to the host.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from cmlpl_tpu_torch.data.patches import gather_patches, gather_spectra
from cmlpl_tpu_torch.data.prep import PreparedScene
from cmlpl_tpu_torch.ops.patch_gather import (gather_patches_bf16,
                                              gather_patches_f32)

GATHERS = ("auto", "xla", "pallas", "pallas_bf16")


def resolve_gather(gather: str, device: torch.device) -> str:
    """``auto`` -> the f32 CUDA kernel on the card, the plain gather on the
    CPU (``cmlpl_tpu/eval/inference.py:32-36``)."""
    if gather != "auto":
        return gather
    return "pallas" if device.type == "cuda" else "xla"


class ScenePredictor:
    """Classifies every pixel of a prepared scene.

    ``model(xp, x) -> logits`` abstracts the network.  ``gather``:
    "pallas" (the f32 CUDA kernel), "pallas_bf16" (the bf16 CUDA kernel
    over a bf16 copy of the cube, made once per call; patch INPUTS are
    bf16-quantised then upcast, so boundary pixels can flip class vs f32),
    "xla" (the plain PyTorch gather), or "auto" (see
    :func:`resolve_gather`).
    """

    def __init__(self, model: Callable, *, patch_size: int, cols: int,
                 tile: int = 4096, gather: str = "auto"):
        if gather == "dense":
            raise NotImplementedError(
                "gather='dense' (dense whole-scene eval) is not ported yet: "
                "ROADMAP.md section 1, 'Dense whole-scene eval'")
        if gather not in GATHERS:
            raise ValueError(f"unknown gather {gather!r}; one of {GATHERS}")
        self.model = model
        self.patch_size = patch_size
        self.cols = cols
        self.tile = tile
        self.gather = gather

    def _gather_fn(self, mode: str):
        w, cols = self.patch_size, self.cols
        if mode == "pallas":
            return lambda cube, ids: gather_patches_f32(cube, ids, cols=cols,
                                                        w=w)
        if mode == "pallas_bf16":
            return lambda cube, ids: gather_patches_bf16(
                cube, ids, cols=cols, w=w).float()
        return lambda cube, ids: gather_patches(cube, ids, cols=cols, w=w)

    @torch.inference_mode()
    def __call__(self, scene: PreparedScene) -> np.ndarray:
        """Returns 0-based predicted class ids for all rows*cols pixels."""
        device = scene.device
        mode = resolve_gather(self.gather, device)
        gather = self._gather_fn(mode)
        cube = scene.padded_pca
        if mode == "pallas_bf16":
            cube = cube.to(torch.bfloat16)

        k = scene.num_pixels
        tile = self.tile
        padded_k = -(-k // tile) * tile
        idx = np.arange(padded_k, dtype=np.int32)
        idx[k:] = 0  # padding pixels classify pixel 0; discarded below
        idx = torch.from_numpy(idx).to(device)
        preds = torch.empty(padded_k, dtype=torch.int32, device=device)
        for start in range(0, padded_k, tile):
            ids = idx[start:start + tile]
            logits = self.model(gather(cube, ids),
                                gather_spectra(scene.spectra, ids))
            preds[start:start + tile] = torch.argmax(logits, dim=-1)
        return preds[:k].cpu().numpy()
