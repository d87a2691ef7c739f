"""Port host data vs the JAX package: synthetic scene, scene prep, splits.

All of it is exact: the port copies the host NumPy code, so the prepared
cube, the spectra and the split arrays must be array-equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cmlpl_tpu.data import generate_splits as jax_generate_splits
from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.data import synthetic_scene as jax_synthetic_scene
from cmlpl_tpu.registry import DATASETS as JAX_DATASETS
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.data.splits import generate_splits
from cmlpl_tpu_torch.registry import DATASETS
from torch_port_threads import one_torch_thread  # noqa: F401


def test_registry_matches():
    assert DATASETS.keys() == JAX_DATASETS.keys()
    for k, spec in DATASETS.items():
        want = dataclasses.asdict(JAX_DATASETS[k])
        got = dataclasses.asdict(spec)
        np.testing.assert_array_equal(got.pop("palette"),
                                      want.pop("palette"))
        assert got == want


@pytest.mark.parametrize("kw", [{}, {"seed": 3, "rows": 20, "cols": 30,
                                      "noise_std": 0.3, "class_sep": 0.5}])
def test_synthetic_scene_equal(kw):
    cube, gt = synthetic_scene(0, **kw)
    jcube, jgt = jax_synthetic_scene(0, **kw)
    np.testing.assert_array_equal(cube, jcube)
    np.testing.assert_array_equal(gt, jgt)


@pytest.mark.parametrize("w", [20, 9])
def test_prepare_scene_equal(w):
    cube, gt = synthetic_scene(0)
    got = prepare_scene(0, cube=cube, gt=gt, patch_size=w, n_pc=16,
                        device="cpu")
    want = jax_prepare_scene(0, cube=cube, gt=gt, patch_size=w, n_pc=16)
    assert got.padded_pca.device.type == "cpu"
    assert got.padded_pca.dtype == torch.float32
    np.testing.assert_array_equal(got.padded_pca.numpy(),
                                  np.asarray(want.padded_pca))
    np.testing.assert_array_equal(got.spectra.numpy(),
                                  np.asarray(want.spectra))
    np.testing.assert_array_equal(got.labels, want.labels)
    assert (got.rows, got.cols, got.num_pixels) == (
        want.rows, want.cols, want.num_pixels)


def test_prepare_scene_substitutes_missing_mat(tmp_path):
    """An absent .mat warns and substitutes the synthetic scene, as the JAX
    loader does."""
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        got = prepare_scene(4, root=str(tmp_path), n_pc=8, device="cpu")
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        want = jax_prepare_scene(4, root=str(tmp_path), n_pc=8)
    np.testing.assert_array_equal(got.padded_pca.numpy(),
                                  np.asarray(want.padded_pca))


@pytest.mark.parametrize("num_label", [5, 10])
def test_generate_splits_identical(num_label):
    _, gt = synthetic_scene(0)
    got = generate_splits(gt.reshape(-1), num_label=num_label)
    want = jax_generate_splits(gt.reshape(-1), num_label=num_label)
    for name in ("train", "test", "unlabeled"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        assert a.tobytes() == b.tobytes(), name
