"""Scene preparation: normalisation, PCA, and the prepared-scene container.

``feature_normalize`` and ``pca_norm`` run on host NumPy exactly as in
``cmlpl_tpu/data/prep.py`` (reference ``tools/hyper_tools.py:8-32``), so
the PCA features are byte-identical to the JAX package's.
``PreparedScene`` keeps the symmetric-padded PCA cube and the z-scored
full-band spectra as torch tensors on an explicit device; patches are
gathered from the cube on the fly, never materialised.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cmlpl_tpu_torch.data.io import load_scene
from cmlpl_tpu_torch.data.patches import pad_symmetric, patch_pad_width
from cmlpl_tpu_torch.device import resolve_device
from cmlpl_tpu_torch.registry import DatasetSpec, get_dataset
from cmlpl_tpu_torch.utils.profiling import span


def feature_normalize(X: np.ndarray, kind: int = 1) -> np.ndarray:
    """kind==1: per-column z-score; kind==2: per-column min-max."""
    if kind == 1:
        mu = np.mean(X, 0)
        Xc = X - mu
        return Xc / np.std(Xc, 0)
    if kind == 2:
        lo, hi = np.min(X, 0), np.max(X, 0)
        return (X - lo) / (hi - lo)
    raise ValueError(f"unknown normalization kind {kind}")


def pca_norm(X: np.ndarray, n_pc: int) -> np.ndarray:
    """Project pixels onto the first ``n_pc`` principal components.

    Matches the reference: SVD of the (N-1)-normalised covariance of the
    centered pixel matrix, projection onto the leading left singular
    vectors (``hyper_tools.py:25-32``).
    """
    mu = np.mean(X, 0)
    Xc = X - mu
    sigma = np.cov(Xc.T)
    U, _, _ = np.linalg.svd(sigma)
    return np.dot(Xc, U[:, :n_pc])


@dataclasses.dataclass
class PreparedScene:
    """Device-resident prepared scene.

    Attributes:
      spec: dataset constants.
      padded_pca: (rows + 2*hw, cols + 2*hw, n_pc) float32 — the
        symmetric-padded, z-scored PCA cube patches are gathered from.
      spectra: (rows*cols, bands) float32 — z-scored full spectra.
      labels: (rows*cols,) int32 host array, 0 = unlabeled background
        (1-based classes, as in the raw ground truth).
      patch_size: spatial patch width w.
      n_pc: number of PCA components (patch channel count).
    """

    spec: DatasetSpec
    padded_pca: torch.Tensor
    spectra: torch.Tensor
    labels: np.ndarray
    patch_size: int
    n_pc: int

    @property
    def rows(self) -> int:
        return self.spec.rows

    @property
    def cols(self) -> int:
        return self.spec.cols

    @property
    def num_pixels(self) -> int:
        return self.spec.num_pixels

    @property
    def device(self) -> torch.device:
        return self.padded_pca.device


def prepare_scene(data_id, root: str = "./dataset", patch_size: int = 20,
                  n_pc: int = 60,
                  cube: Optional[np.ndarray] = None,
                  gt: Optional[np.ndarray] = None,
                  device=None) -> PreparedScene:
    """Full prep pipeline (reference ``SampleGen``, hyper_tools.py:246-297):
    load cube -> PCA(n_pc) + z-score -> symmetric pad (patch source);
    z-score raw spectra; flatten labels.  The cube and spectra are placed
    on ``device`` (default: the CUDA card, see ``resolve_device``).
    Under a profiler its parts are the spans ``prep.pca``,
    ``prep.spectra``, ``prep.pad`` and ``prep.upload``
    (``utils/profiling.span``).
    """
    device = resolve_device(device)
    spec = get_dataset(data_id)
    if cube is None or gt is None:
        cube, gt = load_scene(spec, root)
    rows, cols, bands = cube.shape
    if (rows, cols) != (spec.rows, spec.cols):
        # synthetic scenes may be smaller than the registered dims
        spec = dataclasses.replace(spec, rows=rows, cols=cols)

    flat = cube.reshape(rows * cols, bands)
    with span("prep.pca"):
        x_pca = feature_normalize(pca_norm(flat, n_pc), 1)
        x_pca = x_pca.reshape(rows, cols, n_pc).astype(np.float32)
    with span("prep.spectra"):
        spectra = feature_normalize(flat, 1).astype(np.float32)

    with span("prep.pad"):
        padded = np.ascontiguousarray(pad_symmetric(
            x_pca, patch_pad_width(patch_size)))

    with span("prep.upload"):
        padded_pca = torch.from_numpy(padded).to(device)
        spectra = torch.from_numpy(spectra).to(device)
    return PreparedScene(
        spec=spec,
        padded_pca=padded_pca,
        spectra=spectra,
        labels=np.asarray(gt).reshape(-1).astype(np.int32),
        patch_size=patch_size,
        n_pc=n_pc,
    )
