"""Dense whole-scene eval on the CPU: the port's ``dense_scene_logits`` vs
the JAX package's on the same weights (BaseNet2 params and a CCT tree),
its one divergence from the tiled map, its errors, and ``--eval_gather
dense`` through the entry points.

Tolerance: both run the same f32 dilated convolutions, pools and 25-view
classifier fold over the 64x48 scene, summed in another order by XLA:CPU
and oneDNN; the logits (|logit| < 2) agree to atol 1e-5 (measured: 3.6e-7).
"""

import io
import json

import numpy as np
import pytest
import torch

from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.eval.inference import dense_scene_logits as jax_dense
from cmlpl_tpu_torch.cli import predict, serve
from cmlpl_tpu_torch.cli import train as cli_train
from cmlpl_tpu_torch.cli import train_cct as cli_train_cct
from cmlpl_tpu_torch.cli import train_cps as cli_train_cps
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.patches import gather_patches
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.data.splits import generate_splits
from cmlpl_tpu_torch.eval import inference
from cmlpl_tpu_torch.eval.inference import ScenePredictor, dense_scene_logits
from cmlpl_tpu_torch.eval.metrics import cal_accuracy
from cmlpl_tpu_torch.models.basenet import BaseNet2
from cmlpl_tpu_torch.weights import (init_basenet2_params, init_cct_params,
                                     load_params_npz, save_params_npz,
                                     state_dict_from_jax)
from torch_port_threads import one_torch_thread  # noqa: F401

W, N_PC = 20, 16
SHAPE = dict(n_pc=N_PC, num_features=103, num_classes=9, patch_size=W)
DENSE_TOL = dict(rtol=0, atol=1e-5)
#: a pixel's class may differ only where the two best logits lie closer
#: than this: f32 sums in another order can swap them
TIE_GAP = 1e-4


@pytest.fixture(scope="module")
def scenes():
    cube, gt = synthetic_scene(0)
    return (jax_prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC),
            prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC,
                          device="cpu"))


def _tree(kind):
    if kind == "basenet2":
        return init_basenet2_params(7, **SHAPE)
    return init_cct_params(8, **SHAPE)


def _assert_maps_agree(got, logits):
    """``got`` is the argmax of ``logits`` but where the top two tie."""
    diff = np.nonzero(got != logits.argmax(-1))[0]
    top2 = np.sort(logits[diff], axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] < TIE_GAP).all(), diff


@pytest.mark.parametrize("kind", ["basenet2", "cct"])
def test_dense_logits_match_jax(scenes, kind):
    jscene, scene = scenes
    tree = _tree(kind)
    want = np.asarray(jax_dense(tree, jscene))
    got = dense_scene_logits(state_dict_from_jax(tree), scene)
    assert got.shape == want.shape == (64 * 48, 9)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **DENSE_TOL)


def test_dense_differs_from_the_tiled_map_by_conv_padding_only(scenes):
    """JAX's own property (tests/test_eval.py::
    test_dense_disagreement_is_conv_pad_semantics_only): with conv1 and
    conv2 cut to their centre tap, padding can change nothing, and the
    dense logits equal the tiled map's (the BaseNet2 forward on gathered
    patches) at every pixel, border and interior."""
    _, scene = scenes
    tree = _tree("basenet2")
    for layer in ("conv1", "conv2"):
        k = np.zeros_like(tree[layer]["kernel"])
        k[1, 1] = tree[layer]["kernel"][1, 1]
        tree[layer]["kernel"] = k
    sd = state_dict_from_jax(tree)
    model = BaseNet2(**SHAPE).eval()
    model.load_state_dict(sd)
    ids = torch.arange(scene.num_pixels, dtype=torch.int32)
    with torch.no_grad():
        tiled = torch.cat([
            model(gather_patches(scene.padded_pca, t, cols=scene.cols, w=W),
                  scene.spectra[t.long()])[0] for t in ids.split(512)])
    dense = dense_scene_logits(sd, scene)
    np.testing.assert_allclose(dense.numpy(), tiled.numpy(), rtol=0,
                               atol=2e-5)


def test_dense_convolutions_run_with_tf32_off(scenes, monkeypatch):
    """The dense pass is f32 whatever the process's TF32 switches (cuDNN's
    default is TF32 on), and leaves them as it found them."""
    _, scene = scenes
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append(tuple(f.allow_tf32 for f in flags))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    saved = tuple(f.allow_tf32 for f in flags)
    try:
        for f in flags:
            f.allow_tf32 = True
        dense_scene_logits(state_dict_from_jax(_tree("basenet2")), scene)
        assert seen == [(False, False)] * 3
        assert all(f.allow_tf32 for f in flags)
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def test_dense_needs_w_a_multiple_of_4():
    cube, gt = synthetic_scene(0)
    scene = prepare_scene(0, cube=cube, gt=gt, patch_size=10, n_pc=N_PC,
                          device="cpu")
    sd = state_dict_from_jax(init_basenet2_params(0, **dict(SHAPE,
                                                            patch_size=10)))
    with pytest.raises(ValueError, match="patch_size % 4"):
        dense_scene_logits(sd, scene)


@pytest.mark.parametrize("drop", ["classifier.weight", "encoder.conv1.bias",
                                  "dec_base.fc.bias"])
def test_dense_rejects_other_param_trees(scenes, drop):
    """A tree that is neither BaseNet2's nor CCT's (here: one with a layer
    missing) raises, as in JAX; so does a dense predictor with no
    weights."""
    _, scene = scenes
    kind = "basenet2" if drop.startswith("classifier") else "cct"
    sd = state_dict_from_jax(_tree(kind))
    del sd[drop]
    with pytest.raises(ValueError, match="BaseNet2/CCT-shaped"):
        dense_scene_logits(sd, scene)
    with pytest.raises(ValueError, match="needs the weights"):
        ScenePredictor(None, patch_size=W, cols=48, gather="dense")


def test_predict_and_serve_dense_match_jax(scenes, tmp_path, capsys):
    """``--eval_gather dense`` through predict and serve: JAX's dense map
    (but for ties), and serve's map of the same cube is predict's."""
    jscene, scene = scenes
    tree = _tree("basenet2")
    weights = str(tmp_path / "w.npz")
    save_params_npz(weights, tree)
    common = ["--dataID", "0", "--n_PC", str(N_PC), "--w", str(W),
              "--weights", weights, "--device", "cpu", "--eval_gather",
              "dense"]
    pred = predict.main(common + ["--out", str(tmp_path / "p.svg")])
    assert "OA=" in capsys.readouterr().out
    assert pred.shape == (64 * 48,) and pred.dtype == np.int32
    _assert_maps_agree(pred, np.asarray(jax_dense(tree, jscene)))
    np.testing.assert_array_equal(
        pred, ScenePredictor(None, params=state_dict_from_jax(tree),
                             patch_size=W, cols=48, gather="dense")(scene))

    cube = str(tmp_path / "cube.npy")
    np.save(cube, synthetic_scene(0)[0])
    stdout = io.StringIO()
    serve.main(common + ["--no_warmup"], stdin=io.StringIO(json.dumps(
        {"id": "d", "cube": cube, "out": str(tmp_path / "d.npy")}) + "\n"),
        stdout=stdout)
    response = json.loads(stdout.getvalue().splitlines()[-1])
    assert response["id"] == "d" and "error" not in response
    np.testing.assert_array_equal(np.load(tmp_path / "d.npy"), pred)


@pytest.mark.parametrize("cli", [cli_train, cli_train_cps, cli_train_cct],
                         ids=["train", "train_cps", "train_cct"])
def test_training_clis_map_densely(monkeypatch, tmp_path, capsys, cli):
    """``--eval_gather dense`` maps each trained model with the dense pass,
    once a net: the reported OA is that of the dense map of the weights
    the CLI wrote."""
    calls = []

    def counted(params, scene):
        calls.append(scene.patch_size)
        return dense_scene_logits(params, scene)

    monkeypatch.setattr(inference, "dense_scene_logits", counted)
    weights = str(tmp_path / "w.npz")
    got = cli.main(["--dataID", "0", "--n_PC", str(N_PC), "--num_epochs",
                    "1", "--labeled_batch_size", "16",
                    "--unlabeled_batch_size", "16", "--num_unlabel", "64",
                    "--val_batch_size", "256", "--device", "cpu",
                    "--eval_gather", "dense", "--print_per_batches", "0",
                    "--save_path_prefix", str(tmp_path), "--weights_out",
                    weights])
    acc = got if cli is cli_train_cct else got[0]   # net B's
    assert len(calls) == (1 if cli is cli_train_cct else 2)
    assert "full-scene inference time" in capsys.readouterr().out

    cube, gt = synthetic_scene(0)
    scene = prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC,
                          device="cpu")
    pred = dense_scene_logits(state_dict_from_jax(load_params_npz(weights)),
                              scene).argmax(-1).numpy()
    splits = generate_splits(scene.labels, num_label=5)
    assert cal_accuracy(pred[splits.test],
                        scene.labels[splits.test] - 1).oa == acc.oa
