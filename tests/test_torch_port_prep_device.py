"""The device prep (``data/prep.prepare_tensors``) and its column-sum kernel
(``ops/column_sums``), held on the CPU through the kernel's plain version.

The card runs the same function with the CUDA kernel; its tests are in
``test_torch_port_prep_card.py``.  Here: the plain column sums equal
NumPy's ``sum(0)`` bit for bit, the device path's spectra equal the host
prep's bit for bit and its padded PCA cube is within one f32 step of the
host's at the features' unit scale (the f64 covariance and projection add
in another order), the card's path is taken where the caller asks for it
(``serve`` does) on a CUDA device with a float cube, and the wrapper
refuses what the kernel does not take.
"""

import io
import json

import numpy as np
import pytest
import torch

from cmlpl_tpu_torch.data import prep
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.ops.column_sums import column_sums_plain, column_sums_seq
from torch_port_threads import one_torch_thread  # noqa: F401

#: share of the padded PCA cube's elements that may differ from the host's
PCA_UNEQUAL_MAX = 0.02
DTYPES = {"f32": np.float32, "f64": np.float64}


def _cube(rows: int, dtype, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        1000.0, 100.0, (rows, 103)).astype(dtype)


@pytest.mark.parametrize("centred", [False, True], ids=["sum", "squares"])
@pytest.mark.parametrize("rows", [1, 7, 4099])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_plain_column_sums_equal_numpy(dtype, rows, centred):
    x = _cube(rows, DTYPES[dtype])
    launches = column_sums_seq.launches
    if centred:
        c = x.mean(0)
        d = x - c
        want = (d * d).sum(0)
        got = column_sums_seq(torch.from_numpy(x), torch.from_numpy(c))
    else:
        want = x.sum(0)
        got = column_sums_seq(torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert column_sums_seq.launches == launches   # the CPU launches nothing


def _host_and_device(cube: np.ndarray, w: int, n_pc: int):
    rows, cols, bands = cube.shape
    host = prep.prepare_scene(0, cube=cube, gt=np.zeros((rows, cols)),
                              patch_size=w, n_pc=n_pc, device="cpu")
    flat = torch.from_numpy(cube.reshape(rows * cols, bands))
    padded, spectra = prep.prepare_tensors(flat, rows, cols, n_pc, w)
    return host, padded, spectra


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("n_pc", [16, 60, 103])
@pytest.mark.parametrize("w", [20, 9, 7])
def test_device_path_matches_the_host_prep(w, n_pc, dtype):
    cube, _ = synthetic_scene(0)
    host, padded, spectra = _host_and_device(cube.astype(DTYPES[dtype]), w,
                                             n_pc)
    assert spectra.dtype == padded.dtype == torch.float32
    assert spectra.is_contiguous() and padded.is_contiguous()
    np.testing.assert_array_equal(spectra.numpy(), host.spectra.numpy())
    got, want = padded.numpy(), host.padded_pca.numpy()
    assert got.shape == want.shape
    # one f32 step of the z-scored features' scale (1), or of the value
    step = np.spacing(np.maximum(np.abs(want), np.float32(1)))
    assert (np.abs(got - want) <= step).all()
    assert (got != want).mean() <= PCA_UNEQUAL_MAX


@pytest.mark.parametrize("on_card", [False, True],
                         ids=["training", "serving"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16],
                         ids=["f32", "f64", "int16"])
def test_a_cpu_device_takes_the_host_path(dtype, on_card):
    cube, gt = synthetic_scene(0)
    device, host = prep.DEVICE_PREPS, prep.HOST_PREPS
    scene = prep.prepare_scene(0, cube=cube.astype(dtype), gt=gt,
                               patch_size=9, n_pc=16, device="cpu",
                               on_card=on_card)
    assert (prep.DEVICE_PREPS, prep.HOST_PREPS) == (device, host + 1)
    assert scene.padded_pca.device.type == "cpu"


@pytest.mark.parametrize("device, dtype, on_device", [
    ("cuda", np.float32, True), ("cuda", np.float64, True),
    ("cuda", np.int16, False), ("cuda", np.uint16, False),
    ("cuda", np.float16, False), ("cpu", np.float32, False),
])
def test_the_path_follows_device_and_dtype(device, dtype, on_device):
    assert prep.prepares_on_device(torch.device(device), dtype) is on_device


def _refusal(case: str):
    x = torch.zeros(5, 3)
    return {
        "device": (torch.empty(5, 3, device="meta"), None),
        "dtype_int": (torch.zeros(5, 3, dtype=torch.int32), None),
        "dtype_half": (torch.zeros(5, 3, dtype=torch.float16), None),
        "rank_1": (torch.zeros(5), None),
        "rank_3": (torch.zeros(5, 3, 2), None),
        "no_rows": (torch.zeros(0, 3), None),
        "strided": (torch.zeros(3, 5).T, None),
        "centre_dtype": (x, torch.zeros(3, dtype=torch.float64)),
        "centre_shape": (x, torch.zeros(4)),
        "centre_device": (x, torch.empty(3, device="meta")),
        "centre_strided": (x, torch.zeros(3, 2)[:, 0]),
    }[case]


@pytest.mark.parametrize("case, error", [
    ("device", ValueError), ("dtype_int", TypeError),
    ("dtype_half", TypeError), ("rank_1", ValueError),
    ("rank_3", ValueError), ("no_rows", ValueError), ("strided", ValueError),
    ("centre_dtype", TypeError), ("centre_shape", ValueError),
    ("centre_device", ValueError), ("centre_strided", ValueError),
])
def test_the_wrapper_refuses(case, error):
    x, centre = _refusal(case)
    with pytest.raises(error):
        column_sums_seq(x, centre)


def test_the_plain_version_adds_row_after_row():
    """An order that NumPy's column sum keeps and a pairwise sum does not:
    1 + 2**24 rounds back to 2**24 in f32 at every step."""
    x = np.full((5, 2), 1.0, np.float32)
    x[0] = 2.0 ** 24
    got = column_sums_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, x.sum(0))
    np.testing.assert_array_equal(got, [2.0 ** 24, 2.0 ** 24])


@pytest.mark.parametrize("hw", [0, 2, 10, 25])
@pytest.mark.parametrize("n", [1, 3, 10])
def test_the_pad_index_is_numpys_symmetric_pad(n, hw):
    a = np.arange(n)
    np.testing.assert_array_equal(
        a[prep._pad_index(n, hw, "cpu").numpy()],
        np.pad(a, hw, mode="symmetric"))


def test_serve_asks_for_the_card_prep(tmp_path, monkeypatch):
    """Every scene ``serve`` prepares, the warm-up's f32 and f64 cubes and
    a request's, is asked for on the card (on the CPU: the host's)."""
    from cmlpl_tpu_torch.cli import serve
    from cmlpl_tpu_torch.weights import (init_basenet2_params,
                                         save_params_npz)

    calls = []

    def spy(*args, **kwargs):
        calls.append((kwargs["cube"].dtype, kwargs["on_card"]))
        return prep.prepare_scene(*args, **kwargs)

    monkeypatch.setattr(serve, "prepare_scene", spy)
    wpath = str(tmp_path / "w.npz")
    save_params_npz(wpath, init_basenet2_params(
        0, n_pc=16, num_features=103, num_classes=9, patch_size=9))
    cube, _ = synthetic_scene(0)
    np.save(tmp_path / "cube.npy", cube.astype(np.float32))
    line = json.dumps({"id": "r", "cube": str(tmp_path / "cube.npy"),
                       "out": str(tmp_path / "map.npy")})
    out = io.StringIO()
    serve.main(["--dataID", "0", "--n_PC", "16", "--w", "9",
                "--val_batch_size", "1024", "--weights", wpath,
                "--device", "cpu"], stdin=io.StringIO(line + "\n"),
               stdout=out)
    assert json.loads(out.getvalue().splitlines()[-1])["id"] == "r"
    assert calls == [(np.float32, True), (np.float64, True),
                     (np.float32, True)]
