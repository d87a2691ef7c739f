"""``cmlpl_tpu_torch.cli.sample_generation`` and the chunked host patch
extractor against the JAX package's CLI and its host extraction
(``cmlpl_tpu.native``), on the CPU.

The split files and the z-scored spectra are host NumPy in both packages,
so they are held byte for byte.  ``XP.npy`` is a copy of windows of the
same padded cube, so it is held equal too, whatever the chunking.
"""

import os

import numpy as np
import pytest

from cmlpl_tpu.cli.sample_generation import main as jax_main
from cmlpl_tpu.native import extract_patches_native, pad_symmetric_native
from cmlpl_tpu_torch.cli.sample_generation import main
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.patches import (chunk_rows, extract_patches,
                                          pad_symmetric, patch_pad_width)

FILES = ("X.npy", "Y.npy", "train_array.npy", "test_array.npy",
         "unlabel_array.npy")


def _both(tmp_path, argv):
    """Both CLIs with ``argv`` into their own data roots; returns the two
    output directories (``<root>/Synthetic``)."""
    dirs = []
    for name, fn in (("jax", jax_main), ("port", main)):
        root = tmp_path / name
        fn(argv + ["--data_root", str(root)])
        dirs.append(root / "Synthetic")
    return dirs


def test_split_files_byte_equal_on_the_registered_scene(tmp_path, capsys):
    jdir, pdir = _both(tmp_path, ["--dataID", "0", "--num_label", "5",
                                  "--n_PC", "16"])
    for f in FILES:
        assert (pdir / f).read_bytes() == (jdir / f).read_bytes(), f
    assert not (pdir / "XP.npy").exists()
    assert np.load(pdir / "train_array.npy").shape == (45,)
    assert "wrote splits for Synthetic" in capsys.readouterr().out


def test_scene_npz_files_and_patches_equal(tmp_path, capsys):
    """A 28x24 ``--scene_npz`` with ``--materialize_patches``: the five
    files byte-equal, and ``XP.npy`` (NCHW, written into a memory-mapped
    file chunk by chunk) equal to the JAX CLI's."""
    cube, gt = synthetic_scene(0, rows=28, cols=24)
    npz = tmp_path / "scene.npz"
    np.savez(npz, cube=cube, gt=gt)
    jdir, pdir = _both(tmp_path, ["--dataID", "0", "--n_PC", "8", "--w",
                                  "9", "--scene_npz", str(npz),
                                  "--materialize_patches"])
    for f in FILES:
        assert (pdir / f).read_bytes() == (jdir / f).read_bytes(), f
    got = np.load(pdir / "XP.npy")
    assert got.shape == (28 * 24, 8, 9, 9) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.load(jdir / "XP.npy"))
    assert "XP.npy (672, 8, 9, 9) in 1 chunks" in capsys.readouterr().out


@pytest.mark.parametrize("w", [20, 9])
def test_extract_patches_equals_the_native_extractor(w):
    """Chunks of 3 scene rows (a chunk far smaller than the scene) give
    the host extractor's NCHW patches at an even and an odd ``w``."""
    rows, cols, channels = 23, 17, 5
    x = np.random.default_rng(w).normal(
        size=(rows, cols, channels)).astype(np.float32)
    hw = patch_pad_width(w)
    padded = pad_symmetric(x, hw)
    np.testing.assert_array_equal(padded, pad_symmetric_native(x, hw))
    chunk = 3 * cols * channels * w * w * 4
    assert chunk_rows(cols, channels, w, chunk) == 3
    out = np.full((rows * cols, channels, w, w), np.nan, np.float32)
    got = extract_patches(padded, rows, cols, w, out=out, chunk_bytes=chunk)
    assert got is out
    want = extract_patches_native(pad_symmetric_native(x, hw), rows, cols,
                                  w, layout="nchw")
    np.testing.assert_array_equal(got, want)
    # pixel k = r * cols + c is the window at (r, c) of the padded cube
    k = 5 * cols + 11
    np.testing.assert_array_equal(
        got[k], padded[5:5 + w, 11:11 + w].transpose(2, 0, 1))


def test_takes_no_device(tmp_path):
    with pytest.raises(SystemExit):
        main(["--dataID", "0", "--device", "cpu", "--data_root",
              str(tmp_path)])
    assert not os.listdir(tmp_path)
