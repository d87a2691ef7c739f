""".mat scene ingestion + synthetic scene generation.

Mirrors the loader table in the reference (``tools/hyper_tools.py:250-277``):
scipy ``loadmat`` for PaviaU / Salinas / Houston, HDF5 (MATLAB v7.3) for
Indian Pines.  The reference used ``hdf5storage``; we use ``h5py`` (present
in the image) for the same files.

A synthetic scene generator is provided for tests and benchmarks, since the
public cubes are not vendored.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from cmlpl_tpu_torch.registry import DatasetSpec, get_dataset


def _load_mat_key(path: str, key: str, hdf5: bool) -> np.ndarray:
    """Load one array from a .mat file, tolerating either storage format.

    The registry records which format the REFERENCE used per file
    (hyper_tools.py:250-277: hdf5storage for Indian Pines, scipy
    elsewhere), but the public mirrors serve some cubes in the other
    format (e.g. ehu.eus Indian Pines is MATLAB v5).  Try the recorded
    format first, then the other one.
    """

    def _via_h5py() -> np.ndarray:
        import h5py

        with h5py.File(path, "r") as f:
            # MATLAB v7.3 stores arrays transposed relative to scipy
            return np.asarray(f[key]).T

    def _via_scipy() -> np.ndarray:
        import scipy.io as sio

        return np.asarray(sio.loadmat(path)[key])

    first, second = (_via_h5py, _via_scipy) if hdf5 else (_via_scipy,
                                                          _via_h5py)
    try:
        return first()
    except (NotImplementedError, OSError, ValueError):
        # scipy raises NotImplementedError on v7.3; h5py raises OSError
        # on v5 ("file signature not found")
        return second()


def load_scene(data_id, root: str = "./dataset") -> Tuple[np.ndarray, np.ndarray]:
    """Load the raw cube ``X (rows, cols, bands)`` and ground truth
    ``Y (rows, cols)`` for a registered dataset.

    Falls back to a deterministic synthetic scene for dataID 0, or when the
    .mat files are absent (so every pipeline stage stays runnable without
    the public cubes).
    """
    spec = get_dataset(data_id)
    if spec.cube_file is None:
        return synthetic_scene(spec)
    cube_path = os.path.join(root, spec.cube_file)
    gt_path = os.path.join(root, spec.gt_file)
    if not (os.path.exists(cube_path) and os.path.exists(gt_path)):
        import warnings

        warnings.warn(
            f"{spec.name}: {cube_path} / {gt_path} not found — "
            "substituting a SYNTHETIC scene with the same dims. Accuracy "
            "numbers will NOT be comparable to the real dataset.",
            stacklevel=2)
        return synthetic_scene(spec)
    X = _load_mat_key(cube_path, spec.cube_key, spec.hdf5)
    Y = _load_mat_key(gt_path, spec.gt_key, hdf5=False)
    return X, Y


def synthetic_scene(spec: DatasetSpec | int, seed: int = 7,
                    rows: int | None = None,
                    cols: int | None = None,
                    noise_std: float = 0.08,
                    class_sep: float = 1.0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic synthetic hyperspectral scene.

    Builds ``num_classes`` smooth spectral signatures, assigns classes in
    spatially-coherent blobs (so patch context is informative, like a real
    scene), adds noise, and zeroes out ~25% of pixels as unlabeled
    background (label 0), matching the labeling convention of the real
    cubes (Y==0 means "no ground truth").

    ``noise_std`` scales the additive spectral noise and ``class_sep``
    shrinks signatures toward their mean — lower values make a harder
    scene (used by the method-comparison experiments).
    """
    spec = get_dataset(spec)
    rows = rows or spec.rows
    cols = cols or spec.cols
    bands, ncls = spec.num_bands, spec.num_classes
    rng = np.random.default_rng(seed)

    # smooth per-class signatures: sum of a few random sinusoids over bands
    wl = np.linspace(0.0, 1.0, bands)
    sigs = np.zeros((ncls, bands))
    for c in range(ncls):
        for _ in range(4):
            amp = rng.uniform(0.3, 1.0)
            freq = rng.uniform(1.0, 8.0)
            phase = rng.uniform(0.0, 2 * np.pi)
            sigs[c] += amp * np.sin(2 * np.pi * freq * wl + phase)
        sigs[c] += rng.uniform(2.0, 6.0)  # class-dependent offset

    # spatially coherent labels: nearest of ncls random seed points, per
    # pixel, with a couple of voronoi refinements
    n_blobs = ncls * 6
    centers = np.stack([rng.uniform(0, rows, n_blobs),
                        rng.uniform(0, cols, n_blobs)], axis=1)
    blob_cls = rng.integers(0, ncls, n_blobs)
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    d2 = ((rr[..., None] - centers[:, 0]) ** 2
          + (cc[..., None] - centers[:, 1]) ** 2)
    Y = blob_cls[np.argmin(d2, axis=-1)] + 1  # classes are 1-based

    # background mask (label 0) — deterministic pseudo-random speckle
    bg = rng.random((rows, cols)) < 0.25
    Y = np.where(bg, 0, Y).astype(np.int64)

    if class_sep != 1.0:
        sigs = sigs.mean(0, keepdims=True) + class_sep * (
            sigs - sigs.mean(0, keepdims=True))
    X = sigs[Y - 1].reshape(rows, cols, bands)
    X = X * rng.uniform(0.9, 1.1, size=(rows, cols, 1))
    X = X + rng.normal(0.0, noise_std, size=X.shape)
    # scale into a uint16-like reflectance range like the real cubes
    X = ((X - X.min()) / (X.max() - X.min()) * 8000.0 + 500.0)
    return X.astype(np.float64), Y
