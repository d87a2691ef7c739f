"""On the card only: the device prep against the host prep at PaviaU's
size, and its column-sum kernel against NumPy.

    python -m pytest tests/test_torch_port_prep_card.py -m card --noconftest

(``--noconftest``: ``tests/conftest.py`` imports JAX, which the card's
machine does not have.)  The kernel's sums equal NumPy's ``sum(0)`` bit
for bit; ``prepare_scene(device="cuda", on_card=True)`` of a PaviaU-sized
f32 cube gives the host's spectra bit for bit and its padded PCA cube
within one f32 step (at the features' unit scale) with at most 2% of it
unequal; a BaseNet2 map of each scene is the same but where its two best
logits are within 1e-5 (``chip_smoke.tie_safe_equal``); without
``on_card``, or for an integer cube, the host prepares the scene.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from cmlpl_tpu_torch.cli._common import logits_fn
from cmlpl_tpu_torch.data import prep
from cmlpl_tpu_torch.eval.inference import ScenePredictor
from cmlpl_tpu_torch.models.basenet import BaseNet2
from cmlpl_tpu_torch.ops.column_sums import column_sums_seq
from cmlpl_tpu_torch.weights import init_basenet2_params, state_dict_from_jax
from portbench import scenes

PAVIAU, ROWS, COLS, BANDS, CLASSES = 1, 610, 340, 103, 9
SEED = 2 ** 31 + 19
PCA_UNEQUAL_MAX = 0.02


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cube(card):
    """A PaviaU-sized f32 radiance cube (the benchmark's generator)."""
    stream = scenes.streams(SEED, 1)[0]
    x, _ = scenes.make_scene(stream, ROWS, COLS, BANDS, CLASSES, card)
    return x.cpu().numpy()


@pytest.mark.card
@pytest.mark.parametrize("centred", [False, True], ids=["sum", "squares"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_kernel_equals_numpy(card, dtype, centred):
    x = np.random.default_rng(3).normal(
        1000.0, 100.0, (ROWS * COLS, BANDS)).astype(dtype)
    xt = torch.from_numpy(x).to(card)
    launches = column_sums_seq.launches
    if centred:
        c = x.mean(0)
        d = x - c
        want = (d * d).sum(0)
        got = column_sums_seq(xt, torch.from_numpy(c).to(card))
    else:
        want = x.sum(0)
        got = column_sums_seq(xt)
    torch.cuda.synchronize(card)
    assert column_sums_seq.launches == launches + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def _scenes(cube, card, w, n_pc):
    gt = np.zeros(cube.shape[:2], np.int64)
    device = prep.DEVICE_PREPS
    on_card = prep.prepare_scene(PAVIAU, cube=cube, gt=gt, patch_size=w,
                                 n_pc=n_pc, device=card, on_card=True)
    assert prep.DEVICE_PREPS == device + 1
    host = prep.prepare_scene(PAVIAU, cube=cube, gt=gt, patch_size=w,
                              n_pc=n_pc, device="cpu")
    return on_card, host


@pytest.mark.card
@pytest.mark.parametrize("w, n_pc", [(20, 60), (7, 103)])
def test_device_prep_matches_the_host_prep(card, cube, w, n_pc):
    on_card, host = _scenes(cube, card, w, n_pc)
    for name in ("padded_pca", "spectra"):
        a, b = getattr(on_card, name), getattr(host, name)
        assert a.device.type == "cuda" and a.is_contiguous(), name
        assert a.shape == b.shape and a.dtype == b.dtype, name
    np.testing.assert_array_equal(on_card.spectra.cpu().numpy(),
                                  host.spectra.numpy())
    got, want = on_card.padded_pca.cpu().numpy(), host.padded_pca.numpy()
    step = np.spacing(np.maximum(np.abs(want), np.float32(1)))
    assert (np.abs(got - want) <= step).all()
    assert (got != want).mean() <= PCA_UNEQUAL_MAX


@pytest.mark.card
@pytest.mark.parametrize("dtype, on_card", [(np.int16, True),
                                            (np.float32, False)],
                         ids=["int16", "training"])
def test_the_host_prepares_the_other_scenes(card, cube, dtype, on_card):
    """An integer cube, and any cube not asked for on the card (training's
    prep), take the host path: bit for bit the CPU's scene."""
    cube = cube.astype(dtype)
    gt = np.zeros(cube.shape[:2])
    counts = prep.DEVICE_PREPS, prep.HOST_PREPS
    scene = prep.prepare_scene(PAVIAU, cube=cube, gt=gt, patch_size=20,
                               n_pc=60, device=card, on_card=on_card)
    assert (prep.DEVICE_PREPS, prep.HOST_PREPS) == (counts[0],
                                                    counts[1] + 1)
    host = prep.prepare_scene(PAVIAU, cube=cube, gt=gt, patch_size=20,
                              n_pc=60, device="cpu")
    assert scene.padded_pca.device.type == "cuda"
    assert torch.equal(scene.padded_pca.cpu(), host.padded_pca)
    assert torch.equal(scene.spectra.cpu(), host.spectra)


@pytest.mark.card
def test_basenet2_maps_are_tie_safe_equal(card, cube):
    w, n_pc = 20, 60
    on_card, host = _scenes(cube, card, w, n_pc)
    host = dataclasses.replace(host, padded_pca=host.padded_pca.to(card),
                               spectra=host.spectra.to(card))
    model = BaseNet2(num_features=BANDS, num_classes=CLASSES, n_pc=n_pc,
                     patch_size=w)
    model.load_state_dict(state_dict_from_jax(init_basenet2_params(
        0, n_pc=n_pc, num_features=BANDS, num_classes=CLASSES,
        patch_size=w)))
    apply = logits_fn(model.to(card).eval())
    predictor = ScenePredictor(apply, patch_size=w, cols=COLS, tile=512,
                               gather="pallas")
    got, want = predictor(on_card), predictor(host)
    chip_smoke.tie_safe_equal(got, want,
                              chip_smoke.tiled_logits(apply, host),
                              "device prep vs host prep")
