"""The whole serving slice on the CPU: the port's full-scene map, its
accuracy and its predict/serve entry points vs the JAX package, on the
64x48 synthetic scene (n_pc 16, w 20, tile 128) with the same weights."""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.data.patches import gather_patches as jax_gather_patches
from cmlpl_tpu.eval import ScenePredictor as JaxScenePredictor
from cmlpl_tpu.eval import cal_accuracy as jax_cal_accuracy
from cmlpl_tpu.models import BaseNet2 as JaxBaseNet2
from cmlpl_tpu_torch.cli import predict, serve
from cmlpl_tpu_torch.cli._common import logits_fn
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.data.splits import generate_splits
from cmlpl_tpu_torch.eval.inference import ScenePredictor
from cmlpl_tpu_torch.eval.metrics import cal_accuracy
from cmlpl_tpu_torch.models.basenet import BaseNet2
from cmlpl_tpu_torch.weights import (basenet2_state_dict_from_jax,
                                     init_basenet2_params, save_params_npz)
from torch_port_threads import one_torch_thread  # noqa: F401

W, N_PC, TILE = 20, 16, 128
#: a pixel may differ between the maps only where JAX's two best logits
#: are closer than this: there f32 sums taken in another order can swap them
TIE_GAP = 1e-5


@pytest.fixture(scope="module")
def setup():
    cube, gt = synthetic_scene(0)
    params = init_basenet2_params(11, n_pc=N_PC, num_features=103,
                                  num_classes=9, patch_size=W)
    jmodel = JaxBaseNet2(num_features=103, num_classes=9, n_pc=N_PC)
    jscene = jax_prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC)

    def apply(p, xp, x):
        return jmodel.apply({"params": p}, xp, x, train=False)[0]

    jpred = JaxScenePredictor(apply, patch_size=W, cols=jscene.cols,
                              tile=TILE, gather="xla")(params, jscene)

    def jax_gaps(pixels):
        idx = jnp.asarray(pixels, jnp.int32)
        xp = jax_gather_patches(jscene.padded_pca, idx, cols=jscene.cols,
                                w=W)
        top2 = np.sort(np.asarray(apply(params, xp, jscene.spectra[idx])),
                       axis=-1)[:, -2:]
        return top2[:, 1] - top2[:, 0]

    return dict(cube=cube, gt=gt, params=params, jpred=jpred,
                jax_gaps=jax_gaps)


def _model(params):
    model = BaseNet2(num_features=103, num_classes=9, n_pc=N_PC,
                     patch_size=W).eval()
    model.load_state_dict(basenet2_state_dict_from_jax(params))
    return model


def _assert_maps_agree(got, setup):
    want = setup["jpred"]
    assert got.shape == want.shape and got.dtype == np.int32
    diff = np.nonzero(got != want)[0]
    if diff.size:
        gaps = setup["jax_gaps"](diff)
        assert (gaps < TIE_GAP).all(), (diff, gaps)


@pytest.mark.parametrize("gather", ["xla", "pallas", "auto"])
def test_scene_map_matches_jax(setup, gather):
    """On the CPU every gather mode runs the plain gather."""
    scene = prepare_scene(0, cube=setup["cube"], gt=setup["gt"],
                          patch_size=W, n_pc=N_PC, device="cpu")
    got = ScenePredictor(logits_fn(_model(setup["params"])), patch_size=W,
                         cols=scene.cols, tile=TILE, gather=gather)(scene)
    _assert_maps_agree(got, setup)


def test_bf16_gather_map_equals_quantised_xla_map(setup):
    scene = prepare_scene(0, cube=setup["cube"], gt=setup["gt"],
                          patch_size=W, n_pc=N_PC, device="cpu")
    model = logits_fn(_model(setup["params"]))
    got = ScenePredictor(model, patch_size=W, cols=scene.cols, tile=TILE,
                         gather="pallas_bf16")(scene)
    scene.padded_pca = scene.padded_pca.to(torch.bfloat16).float()
    want = ScenePredictor(model, patch_size=W, cols=scene.cols, tile=TILE,
                          gather="xla")(scene)
    np.testing.assert_array_equal(got, want)


def test_cal_accuracy_equal(setup):
    labels = setup["gt"].reshape(-1).astype(np.int32)
    splits = generate_splits(labels, num_label=5)
    pred = setup["jpred"][splits.test]
    truth = labels[splits.test] - 1
    got = cal_accuracy(pred, truth)
    want = jax_cal_accuracy(pred, truth)
    assert (got.oa, got.aa, got.kappa) == (want.oa, want.aa, want.kappa)
    np.testing.assert_array_equal(got.producer, want.producer)


def test_predict_and_serve_mains(setup, tmp_path, capsys):
    weights = str(tmp_path / "w.npz")
    save_params_npz(weights, setup["params"])
    common = ["--dataID", "0", "--n_PC", str(N_PC), "--w", str(W),
              "--val_batch_size", str(TILE), "--weights", weights,
              "--device", "cpu"]

    pred = predict.main(common + ["--out", str(tmp_path / "p.svg")])
    _assert_maps_agree(pred, setup)
    assert "OA=" in capsys.readouterr().out
    assert (tmp_path / "p.svg").read_bytes().startswith(b"<svg")

    np.save(tmp_path / "cube.npy", setup["cube"])
    crop = str(tmp_path / "crop.npy")
    np.save(crop, setup["cube"][:40, :30])
    reqs = [{"cube": str(tmp_path / "cube.npy"), "id": "a",
             "out": str(tmp_path / "a.npy")},
            {"cube": crop, "id": "b", "out": str(tmp_path / "b.png")}]
    stdout = io.StringIO()
    serve.main(common + ["--no_warmup"],
               stdin=io.StringIO("".join(json.dumps(r) + "\n"
                                         for r in reqs) + "not json\n"),
               stdout=stdout)
    lines = [json.loads(s) for s in stdout.getvalue().splitlines()]
    assert lines[0]["ready"] is True
    assert [r.get("id") for r in lines[1:]] == ["a", "b", None]
    assert "error" not in lines[1] and "error" not in lines[2]
    assert "JSONDecodeError" in lines[3]["error"]
    assert lines[1]["pixels"] == 64 * 48 and lines[2]["pixels"] == 40 * 30
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), pred)
    assert (tmp_path / "b.png").read_bytes().startswith(b"\x89PNG")


def test_entry_points_need_weights(tmp_path):
    with pytest.raises(SystemExit):
        predict.main(["--dataID", "0", "--n_PC", str(N_PC), "--device",
                      "cpu"])


@pytest.mark.parametrize("entry", ["predict", "serve"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"predict": predict.main, "serve": serve.main}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--dataID", "0", "--weights", "unused.npz"])
