"""Scene preparation: normalisation, PCA, and the prepared-scene container.

``feature_normalize`` and ``pca_norm`` run on host NumPy exactly as in
``cmlpl_tpu/data/prep.py`` (reference ``tools/hyper_tools.py:8-32``), so
the PCA features are byte-identical to the JAX package's.
``PreparedScene`` keeps the symmetric-padded PCA cube and the z-scored
full-band spectra as torch tensors on an explicit device; patches are
gathered from the cube on the fly, never materialised.

Asked to (``on_card``, the serving path), ``prepare_scene`` uploads a
float32 or float64 cube once and prepares it on its CUDA device
(:func:`prepare_tensors`), step by step as the host does it and in the
same dtypes.  Its column means and standard deviations add in NumPy's
order (``ops/column_sums.column_sums_seq``), so the spectra equal the
host's bit for bit; the PCA's covariance and projection are f64 matrix
products in another order, and its SVD runs on the host as
``np.linalg.svd`` (whose signs the features follow), so the z-scored PCA
features are within one f32 step of the host's at their unit scale (about
1% of them differ, at PaviaU's size).  A map is the same but where two
logits all but tie.  Training is held to the JAX package's and the
benchmark's plain references' results from the same inputs, and a prep
that far off moved SSRN's first gradients by up to 3.7e-4 on an H100
(one seed in twelve); so by default, and for any other device or dtype
(:func:`prepares_on_device`), the host prepares the scene.
:data:`DEVICE_PREPS` and :data:`HOST_PREPS` count the two paths.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cmlpl_tpu_torch.data.io import load_scene
from cmlpl_tpu_torch.data.patches import pad_symmetric, patch_pad_width
from cmlpl_tpu_torch.device import resolve_device
from cmlpl_tpu_torch.ops.column_sums import column_sums_seq
from cmlpl_tpu_torch.registry import DatasetSpec, get_dataset
from cmlpl_tpu_torch.utils.profiling import span

#: scenes prepared on the card (:func:`prepare_tensors`) and on the host
DEVICE_PREPS = 0
HOST_PREPS = 0
#: cube dtypes the card prepares: the host path's own dtypes
DEVICE_DTYPES = (np.float32, np.float64)


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


def prepares_on_device(device: torch.device, dtype) -> bool:
    """Whether :func:`prepare_scene` prepares a cube of ``dtype`` on
    ``device`` itself: a CUDA device and a float32 or float64 cube."""
    return device.type == "cuda" and np.dtype(dtype) in DEVICE_DTYPES


def _mean_seq(x: torch.Tensor, centre: torch.Tensor | None = None):
    """``np.mean(x, 0)`` of a float cube (of its squared deviations from
    ``centre``, when given): NumPy's column sums over the rows, divided in
    ``x``'s dtype (by a tensor: a scalar divisor is a multiply by its
    reciprocal on the card)."""
    sums = column_sums_seq(x, centre)
    return sums / torch.full_like(sums, x.shape[0])


def _pad_index(n: int, hw: int, device) -> torch.Tensor:
    """The source index of each of ``n + 2 hw`` positions of a symmetric
    pad (``np.pad(mode="symmetric")``, which repeats the edge)."""
    i = torch.arange(-hw, n + hw, device=device).remainder(2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def prepare_tensors(x: torch.Tensor, rows: int, cols: int, n_pc: int,
                    patch_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The host prep's (padded PCA cube, spectra) of a contiguous
    (rows * cols, bands) float32 or float64 pixel matrix, computed where
    ``x`` lies, in the host's steps and dtypes: the centring and the
    spectra's z-score in ``x``'s dtype with NumPy's column sums; the PCA
    (``np.cov``'s second centring, its covariance, the projection) and its
    z-score in float64; the SVD of the bands' covariance, and the square
    roots of their variances, on the host."""
    n = x.shape[0]
    with span("prep.pca"):
        xc = x - _mean_seq(x)
        x64 = xc.double()
        c64 = x64 - x64.mean(0)                       # np.cov centres again
        sigma = (c64.T @ c64) * (1.0 / (n - 1))
        u, _, _ = np.linalg.svd(sigma.cpu().numpy())
        proj = x64 @ torch.from_numpy(
            np.ascontiguousarray(u[:, :n_pc])).to(x.device)
        pc = proj - proj.mean(0)
        feats = (pc / pc.std(0, correction=0)).float()
    with span("prep.spectra"):
        # np.std: the centred pixels' mean, then their squared deviations;
        # the bands' square roots by NumPy, as the host takes them (torch's
        # CPU sqrt is not correctly rounded)
        var = _mean_seq(xc, _mean_seq(xc))
        std = torch.from_numpy(np.sqrt(var.cpu().numpy())).to(x.device)
        spectra = (xc / std).float()
    with span("prep.pad"):
        hw = patch_pad_width(patch_size)
        padded = feats.reshape(rows, cols, n_pc).index_select(
            0, _pad_index(rows, hw, x.device)).index_select(
                1, _pad_index(cols, hw, x.device))
    return padded, spectra


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
                  device=None, on_card: bool = False) -> PreparedScene:
    """Full prep pipeline (reference ``SampleGen``, hyper_tools.py:246-297):
    load cube -> PCA(n_pc) + z-score -> symmetric pad (patch source);
    z-score raw spectra; flatten labels.  The cube and spectra are placed
    on ``device`` (default: the CUDA card, see ``resolve_device``).  With
    ``on_card``, a float32 or float64 cube on a CUDA device is prepared
    there (:func:`prepare_tensors`); otherwise on the host, byte-identical
    to the JAX package.
    Under a profiler its parts are the spans ``prep.pca``,
    ``prep.spectra``, ``prep.pad`` and ``prep.upload``
    (``utils/profiling.span``).
    """
    global DEVICE_PREPS, HOST_PREPS
    device = resolve_device(device)
    spec = get_dataset(data_id)
    if cube is None or gt is None:
        cube, gt = load_scene(spec, root)
    rows, cols, bands = cube.shape
    if (rows, cols) != (spec.rows, spec.cols):
        # synthetic scenes may be smaller than the registered dims
        spec = dataclasses.replace(spec, rows=rows, cols=cols)

    flat = cube.reshape(rows * cols, bands)
    if on_card and prepares_on_device(device, flat.dtype):
        with span("prep.upload"):
            x = torch.from_numpy(np.ascontiguousarray(flat)).to(device)
        padded_pca, spectra = prepare_tensors(x, rows, cols, n_pc,
                                              patch_size)
        DEVICE_PREPS += 1
    else:
        padded_pca, spectra = _prepare_host(flat, rows, cols, n_pc,
                                            patch_size, device)
        HOST_PREPS += 1
    return PreparedScene(
        spec=spec,
        padded_pca=padded_pca,
        spectra=spectra,
        labels=np.asarray(gt).reshape(-1).astype(np.int32),
        patch_size=patch_size,
        n_pc=n_pc,
    )


def _prepare_host(flat: np.ndarray, rows: int, cols: int, n_pc: int,
                  patch_size: int, device) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The host prep in NumPy, then the upload of its results."""
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
    return padded_pca, spectra
