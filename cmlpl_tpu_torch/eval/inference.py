"""Full-scene inference (``cmlpl_tpu/eval/inference.py``) on PyTorch: the
tiled map (``ScenePredictor``, ``:144-249,328-364``) and the dense
whole-scene evaluation (``dense_scene_logits``, ``:39-141``).

Tiled: pixel ids are cut into tiles of ``tile`` pixels; each tile gathers
its patches from the device-resident padded cube, runs the forward pass and
argmaxes on the device (the host's part of it is the span ``map.tile``,
recorded only under a profiler: ``utils/profiling.span``).  The
predictions stay on the device until one final (K,) int32 copy to the
host.

Dense: the conv stack runs once over the whole padded cube, with no gather
at all.  It needs the weights, not a callable: ``ScenePredictor`` takes
them as ``params``, a BaseNet2 ``state_dict`` or a CCT model's (keys
``encoder.*`` and ``dec_base.fc.*``).

Over a mesh of ranks (``ScenePredictor(..., mesh=)``, the JAX package's
``shard_map`` over the tile axis, ``:226-249,342-358``) the ids are padded
to a multiple of ``tile`` times the ranks, rank r maps the r-th contiguous
strip of tiles, launching its gather kernel for those tiles only, and the
labels are gathered (int32) to every rank.  The tiles are the one-rank
map's, so the labels are bitwise its labels.  The dense map splits into
contiguous strips of scene rows, ragged where the rows do not divide
(:func:`strip_rows`; the JAX package shards the padded cube's rows with
GSPMD, ``:264-318``): rank r runs the same dilated pass over the slice of
the replicated padded cube that its strip and the conv stack's halo need
(:func:`dense_strip_logits`), and the int32 labels are gathered to every
rank.  A strip's logits are the whole pass's within rounding.

On a ("data", "model") mesh the strips go over the data ranks, and a
model rank maps its data rank's strip (the JAX package's ``shard_map``
over ``mesh.axis_names[0]``), with whole weights: a trainer's sharded
state gives them by ``*_state_to_jax``.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from cmlpl_tpu_torch.core.mesh import (Mesh, gather_rows, is_distributed,
                                       pad_to_multiple)
from cmlpl_tpu_torch.data.patches import gather_patches, gather_spectra
from cmlpl_tpu_torch.data.prep import PreparedScene
from cmlpl_tpu_torch.device import compute_precision
from cmlpl_tpu_torch.ops.patch_gather import (gather_patches_bf16,
                                              gather_patches_f32)
from cmlpl_tpu_torch.utils.profiling import span

GATHERS = ("auto", "xla", "pallas", "pallas_bf16", "dense")

_DENSE_LAYERS = ("conv0", "conv1", "conv2", "feat_spe", "classifier")


def resolve_gather(gather: str, device: torch.device) -> str:
    """``auto`` -> the f32 CUDA kernel on the card, the plain gather on the
    CPU (``cmlpl_tpu/eval/inference.py:32-36``)."""
    if gather != "auto":
        return gather
    return "pallas" if device.type == "cuda" else "xla"


def _dense_params_view(params: Mapping) -> dict:
    """BaseNet2-shaped view of a ``state_dict`` for the dense pass.

    Takes BaseNet2's keys directly, or a CCT model's: the CCT map is
    ``dec_base(encoder(xp, x))`` and CCTNet's stem and (H, W, C) flatten
    are BaseNet2's, so the head takes the classifier's place.  Raises
    ValueError for any other shape."""
    if "dec_base.fc.weight" in params:
        view = {k[len("encoder."):]: v for k, v in params.items()
                if k.startswith("encoder.")}
        for leaf in ("weight", "bias"):
            view[f"classifier.{leaf}"] = params.get(f"dec_base.fc.{leaf}")
        params = view
    keys = [f"{layer}.{leaf}" for layer in _DENSE_LAYERS
            for leaf in ("weight", "bias")]
    missing = [k for k in keys if params.get(k) is None]
    if missing:
        raise ValueError(
            "dense eval requires BaseNet2/CCT-shaped params; missing "
            f"{missing} (use the tiled gather modes for other backbones)")
    return {k: params[k] for k in keys}


def dense_scene_logits(params: Mapping, scene: PreparedScene
                       ) -> torch.Tensor:
    """(rows*cols, classes) f32 logits of the whole scene as ONE dense
    dilated-conv pass over the padded cube (the a-trous transform), with
    no patch gather: the two stride-2 pools become stride-1 pools with
    conv2 at dilation 2 and the second pool at window dilation 2, and each
    pixel's (w/4)^2 x 64 spatial flatten becomes (w/4)^2 shifted views of
    the pooled map folded into the classifier.

    Boundary semantics differ from the tiled map, as in the JAX package: a
    patch zero-pads its own edges inside conv1/conv2, while the dense pass
    sees the true neighbouring pixels.  With conv1/conv2 cut to their
    centre tap the two agree everywhere.

    ``params``: see :func:`_dense_params_view`.  Needs
    ``patch_size % 4 == 0``.  Computes in f32 whatever the model's
    compute dtype, as the JAX package does, with TF32 off."""
    if scene.patch_size % 4 != 0:
        raise ValueError("dense eval needs patch_size % 4 == 0 "
                         f"(got {scene.patch_size})")
    with compute_precision("float32"):
        return _dense_logits(_dense_params_view(params), scene.padded_pca,
                             scene.spectra, scene.rows, scene.cols,
                             scene.patch_size)


def _conv(p: dict, x, layer, dilation=1, padding=0):
    return F.conv2d(x, p[f"{layer}.weight"], p[f"{layer}.bias"],
                    padding=padding, dilation=dilation)


def _dilated_pool(f2: torch.Tensor) -> torch.Tensor:
    """A 2x2 window at dilation 2 (avg_pool2d has no window dilation): the
    sum of four views shifted by 0 and 2 rows and columns."""
    return (f2[..., :-2, :-2] + f2[..., :-2, 2:] + f2[..., 2:, :-2]
            + f2[..., 2:, 2:]) / 4


def _fold(p: dict, p2: torch.Tensor, spectra: torch.Tensor, rows: int,
          cols: int, g: int) -> torch.Tensor:
    """(rows*cols, classes) logits from the pooled map ``p2`` (its row 0
    the first output row's) and those pixels' spectra: each pixel's
    (w/4)^2 x 64 spatial flatten is (w/4)^2 shifted views of ``p2`` folded
    into the classifier."""
    p2 = p2[0].permute(1, 2, 0)                          # (H', W', 64)
    wk = p["classifier.weight"]          # (classes, spatial + 1024)
    logits_sp = torch.zeros(rows, cols, wk.shape[0], device=p2.device)
    for a in range(g):                   # (H, W, C) order of the flatten
        for b in range(g):
            blk = wk[:, (a * g + b) * 64:(a * g + b + 1) * 64]
            logits_sp = logits_sp + (
                p2[4 * a:4 * a + rows, 4 * b:4 * b + cols] @ blk.T)
    y = F.relu(F.linear(spectra.float(), p["feat_spe.weight"],
                        p["feat_spe.bias"]))
    logits_spec = y @ wk[:, 64 * g * g:].T
    return (logits_sp.reshape(rows * cols, -1) + logits_spec
            + p["classifier.bias"])


def _dense_logits(params: dict, padded: torch.Tensor, spectra: torch.Tensor,
                  rows: int, cols: int, patch_size: int) -> torch.Tensor:
    p = {k: v.to(padded.device, torch.float32) for k, v in params.items()}
    cube = padded.float().permute(2, 0, 1)[None]         # (1, C, H, W)
    f0 = _conv(p, cube, "conv0")
    f1 = F.relu(_conv(p, f0, "conv1", padding=1) + f0)
    p1 = F.avg_pool2d(f1, 2, stride=1)
    f2 = F.relu(_conv(p, p1, "conv2", dilation=2, padding=2) + p1)
    return _fold(p, _dilated_pool(f2), spectra, rows, cols, patch_size // 4)


def strip_rows(rows: int, ranks: int, rank: int) -> tuple[int, int]:
    """(r0, r1): rank ``rank``'s contiguous strip of ``rows`` scene rows
    cut into ``ranks`` strips as even as the count allows (610 rows on 3
    ranks: 203, 203, 204)."""
    return rank * rows // ranks, (rank + 1) * rows // ranks


def dense_strip_logits(params: Mapping, scene: PreparedScene, r0: int,
                       r1: int) -> torch.Tensor:
    """((r1 - r0) * cols, classes) f32 logits of scene rows ``r0:r1``: the
    arithmetic of :func:`dense_scene_logits` over the rows of the padded
    cube that the strip and the conv stack's halo need
    (:func:`_dense_strip_logits`); those rows of the whole pass within
    rounding (the convolutions sum over other shapes)."""
    if scene.patch_size % 4 != 0:
        raise ValueError("dense eval needs patch_size % 4 == 0 "
                         f"(got {scene.patch_size})")
    if not 0 <= r0 <= r1 <= scene.rows:
        raise ValueError(f"strip {r0}:{r1} outside the scene's "
                         f"{scene.rows} rows")
    with compute_precision("float32"):
        return _dense_strip_logits(_dense_params_view(params),
                                   scene.padded_pca, scene.spectra,
                                   scene.cols, scene.patch_size, r0, r1)


def _rows_window(x: torch.Tensor, have_lo: int, lo: int, hi: int,
                 n: int) -> torch.Tensor:
    """Rows ``lo:hi`` (dim -2) of a map of ``n`` rows of which ``x`` holds
    rows ``have_lo:``, with the rows outside ``[0, n)`` zero: the
    convolution's own zero padding at the map's edges, and only there."""
    a, b = max(lo, 0), min(hi, n)
    return F.pad(x[..., a - have_lo:b - have_lo, :], (0, 0, a - lo, hi - b))


def _dense_strip_logits(params: dict, padded: torch.Tensor,
                        spectra: torch.Tensor, cols: int, patch_size: int,
                        r0: int, r1: int) -> torch.Tensor:
    """Scene rows ``r0:r1`` of the dense pass.  The halo, with the padded
    cube's H = rows + w rows and g = w / 4: f0 and f1 have H rows, p1 and
    f2 H - 1, p2 H - 3.

    - logit row i reads p2 rows i + 4a for a < g: rows [r0, r1 + w - 4);
    - p2 row j (the pool at dilation 2) reads f2 rows j and j + 2:
      [r0, r1 + w - 2);
    - f2 row k (conv2, 3x3 at dilation 2, zero-padded by 2) reads p1 rows
      k - 2 to k + 2: [r0 - 2, r1 + w);
    - p1 row m (the 2x2 pool) reads f1 rows m and m + 1:
      [r0 - 2, r1 + w + 1);
    - f1 row n (conv1, 3x3 zero-padded by 1) reads f0 rows n - 1 to n + 1,
      and f0 (conv0, 1x1) the cube's same rows: [r0 - 3, r1 + w + 2).

    So a strip of S rows reads S + w + 5 cube rows (fewer at the scene's
    edges).  The convolutions take zeros past the maps' true edges only:
    f0 is padded with zero rows where its window passes them (conv1's
    padding), p1's rows outside [0, H - 1) are zeroed (conv2's), and both
    convolutions pad the columns alone; rows of f1 past its edges are
    computed but never read.  The crops keep the rows each next stage
    reads."""
    p = {k: v.to(padded.device, torch.float32) for k, v in params.items()}
    g = patch_size // 4
    h = padded.shape[0]
    lo, hi = r0 - 3, r1 + patch_size + 2                 # f0's rows
    cube = padded[max(lo, 0):min(hi, h)].float().permute(2, 0, 1)[None]
    f0 = _rows_window(_conv(p, cube, "conv0"), max(lo, 0), lo, hi, h)
    f1 = F.relu(_conv(p, f0, "conv1", padding=(0, 1)) + f0[..., 1:-1, :])
    p1 = _rows_window(F.avg_pool2d(f1, 2, stride=1), lo + 1, r0 - 2,
                      r1 + patch_size, h - 1)
    f2 = F.relu(_conv(p, p1, "conv2", dilation=2, padding=(0, 2))
                + p1[..., 2:-2, :])                      # rows r0:
    return _fold(p, _dilated_pool(f2), spectra[r0 * cols:r1 * cols],
                 r1 - r0, cols, g)


class ScenePredictor:
    """Classifies every pixel of a prepared scene.

    ``model(xp, x) -> logits`` abstracts the network of the tiled modes.
    ``gather``: "pallas" (the f32 CUDA kernel), "pallas_bf16" (the bf16
    CUDA kernel over a bf16 copy of the cube, made once per call; patch
    INPUTS are bf16-quantised then upcast, so boundary pixels can flip
    class vs f32), "xla" (the plain PyTorch gather), "auto" (see
    :func:`resolve_gather`), or "dense" (:func:`dense_scene_logits` from
    ``params``, no gather and no ``model``).  ``spectra=False`` is for a
    model of patches only (a zoo "patch" model): its ``x`` is None and no
    spectra are gathered.  ``mesh``: each rank maps its strip of the tiles
    (dense: of the scene's rows) and every rank returns the whole map (the
    module docstring).
    """

    def __init__(self, model: Callable | None, *, patch_size: int,
                 cols: int, tile: int = 4096, gather: str = "auto",
                 params: Mapping | None = None, spectra: bool = True,
                 mesh: Mesh | None = None):
        if gather not in GATHERS:
            raise ValueError(f"unknown gather {gather!r}; one of {GATHERS}")
        if gather == "dense" and params is None:
            raise ValueError("gather='dense' needs the weights as params")
        self.model = model
        self.params = params
        self.patch_size = patch_size
        self.cols = cols
        self.tile = tile
        self.gather = gather
        self.spectra = spectra
        self.mesh = mesh

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
        mesh = self.mesh if is_distributed(self.mesh) else None
        if self.gather == "dense":
            if mesh is None:
                logits = dense_scene_logits(self.params, scene)
                return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
            r0, r1 = strip_rows(scene.rows, mesh.data_size, mesh.data)
            preds = torch.empty(0, dtype=torch.int32, device=scene.device)
            if r1 > r0:  # fewer scene rows than ranks leave a rank none
                preds = dense_strip_logits(self.params, scene, r0,
                                           r1).argmax(dim=-1).to(torch.int32)
            return gather_rows(preds, mesh, r0 * scene.cols,
                               scene.num_pixels).cpu().numpy()
        device = scene.device
        mode = resolve_gather(self.gather, device)
        gather = self._gather_fn(mode)
        cube = scene.padded_pca
        if mode == "pallas_bf16":
            cube = cube.to(torch.bfloat16)

        k = scene.num_pixels
        tile = self.tile
        ranks = 1 if mesh is None else mesh.data_size
        padded_k = pad_to_multiple(k, tile * ranks)
        lo, hi = (0, padded_k) if mesh is None else mesh.rows(padded_k)
        idx = np.arange(lo, hi, dtype=np.int32)
        idx[idx >= k] = 0  # padding pixels classify pixel 0; discarded below
        idx = torch.from_numpy(idx).to(device)
        preds = torch.empty(hi - lo, dtype=torch.int32, device=device)
        for start in range(0, hi - lo, tile):
            with span("map.tile"):
                ids = idx[start:start + tile]
                x = (gather_spectra(scene.spectra, ids) if self.spectra
                     else None)
                logits = self.model(gather(cube, ids), x)
                preds[start:start + tile] = torch.argmax(logits, dim=-1)
        preds = gather_rows(preds, mesh, lo, padded_k)
        return preds[:k].cpu().numpy()
