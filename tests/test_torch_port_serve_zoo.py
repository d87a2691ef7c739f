"""A zoo model through ``serve`` and ``predict`` (``--model``), held to
the benchmark's plain reference, ``portbench/reference/dbda.py``, on the
CPU.

DBDA's weights are drawn as the benchmark draws them
(``portbench/drivers/serve_zoo.zoo_weights``): every BatchNorm statistic
and both attentions' ``gamma`` non-zero, so a program that left an
attention out, or normalised by the batch, would differ.  The scenes are
small (12 x 12 and 16 x 12 pixels of the synthetic dataset's 103 bands,
5 x 5 patches): a DBDA forward costs ~90 MFLOP a patch there.

- The port's ``DBDA`` in evaluation mode against the reference's
  forward, at 17 bands and at 103: the same float32 operations in the
  same order on the CPU, so equal within ``ATOL`` (what a different
  convolution algorithm's rounding could move a logit of magnitude ~1),
  and each planted fault (``portbench/faults_zoo.py``) moves the logits
  by far more.
- ``serve --model dbda --weights`` on a cube through pipes and ``predict
  --model dbda`` on the synthetic scene: each map's labels are the
  reference's best up to ``TIE`` (``portbench/compare.label_gap``: a
  label may differ only where the reference's logits lie within ``TIE``
  of each other; the maps are prepared on the host by both).
- The flags: DBDA's own ``--w`` 9 and all bands by default; refused
  ``--checkpoint_dir``, ``--eval_gather dense``, a ``--n_PC`` short of
  the bands and a BaseNet2 weights file.
- The spans: one ``map.tile`` a tile of the map, none outside a profiler
  session.
- ``portbench/counts_dbda.py`` against a brute-force count
  (``torch.utils.flop_counter``) of the reference's forward and a mask of
  the covered pixels.
"""

import dataclasses
import io
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from cmlpl_tpu_torch import registry
from cmlpl_tpu_torch.cli import predict, serve
from cmlpl_tpu_torch.cli._common import base_parser, resolve_model
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.eval.inference import ScenePredictor
from cmlpl_tpu_torch.models.dbda import DBDA
from cmlpl_tpu_torch.utils.profiling import take_spans
from cmlpl_tpu_torch.weights import (init_basenet2_params, save_params_npz,
                                     zoo_variables_to_jax)
from portbench import compare, counts_dbda, faults_zoo, scenes
from portbench.drivers.serve_zoo import zoo_weights
from portbench.reference import dbda as ref
from portbench.reference import prep as ref_prep
from torch_port_threads import one_torch_thread  # noqa: F401

BANDS, CLASSES, W = 103, 9, 5
#: logits reach ~1 here; the same ops on the CPU agree to rounding
ATOL = 1e-5
#: a served label may differ from the reference's best by this much
TIE = 1e-5
#: a planted fault moves some logit by more than this
FAULT_MOVES = 1e-2
SEED = 2 ** 31 + 20


def _weights(bands, seed=SEED):
    shapes = ref.shapes(bands, CLASSES)
    return zoo_weights(scenes.streams(seed, 1)[0], shapes, "cpu")


def _model(bands, weights):
    model = DBDA(bands, CLASSES)
    model.load_state_dict(weights)
    return model.eval()


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("zoo") / "dbda.npz"
    save_params_npz(str(path), zoo_variables_to_jax("dbda", _weights(BANDS)))
    return str(path)


@pytest.fixture(autouse=True)
def no_spans_left():
    take_spans()
    yield
    take_spans()


def _reference_labels_gap(weights, cube, labels, w=W):
    padded, _ = ref_prep.prepare(cube, BANDS, w, "cpu")
    logits = ref.scene_logits(weights, padded, cube.shape[0], cube.shape[1],
                              w, 256)
    return compare.label_gap(logits, torch.from_numpy(labels))


@pytest.mark.parametrize("bands", [17, BANDS])
def test_port_dbda_is_the_reference(bands):
    weights = _weights(bands)
    xp = torch.randn(6, 7, 7, bands, generator=torch.Generator()
                     .manual_seed(1))
    with torch.no_grad():
        got = _model(bands, weights)(xp)
        want = ref.forward(weights, xp)
    assert want.abs().max() > 0.1
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def test_the_drawn_weights_keep_the_attentions_alive():
    weights = _weights(BANDS)
    for name in ("trunk.attention_spectral.gamma",
                 "trunk.attention_spatial.gamma"):
        assert 0.5 <= float(weights[name]) < 1.5
    var = weights["trunk.bn14.running_var"]
    assert bool((var >= 0.5).all()) and float(var.std()) > 0.1
    assert float(weights["trunk.bn11.running_mean"].abs().max()) > 0.1


@pytest.mark.parametrize("fault", faults_zoo.FAULTS)
def test_each_planted_fault_parts_the_port_from_the_reference(fault):
    weights = _weights(17)
    xp = torch.randn(6, 7, 7, 17, generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), faults_zoo.planted(fault):
        got = _model(17, weights)(xp)
    want = ref.forward(weights, xp)
    assert float((got - want).abs().max()) > FAULT_MOVES


def _serve(argv, text):
    out = io.StringIO()
    serve.main(argv, stdin=io.StringIO(text), stdout=out)
    return [json.loads(r) for r in out.getvalue().splitlines()]


def test_serve_model_dbda_maps_as_the_reference(tmp_path, weights_file):
    cube = synthetic_scene(0)[0][:12, :12].astype(np.float32)
    np.save(tmp_path / "cube.npy", cube)
    line = json.dumps({"id": "r", "cube": str(tmp_path / "cube.npy"),
                       "out": str(tmp_path / "map.npy")})
    got = _serve(["--dataID", "0", "--model", "dbda", "--weights",
                  weights_file, "--w", str(W), "--val_batch_size", "64",
                  "--device", "cpu", "--no_warmup"], line + "\n")
    assert got[0]["ready"] and got[1]["pixels"] == 144
    labels = np.load(tmp_path / "map.npy")
    assert _reference_labels_gap(_weights(BANDS), cube, labels) <= TIE


@pytest.fixture
def small_dataset(monkeypatch):
    """The synthetic dataset at 16 x 12 pixels, so predict maps it in a
    second."""
    spec = dataclasses.replace(registry.DATASETS[0], rows=16, cols=12)
    monkeypatch.setitem(registry.DATASETS, 0, spec)
    return spec


def test_predict_model_dbda_maps_as_the_reference(tmp_path, weights_file,
                                                  small_dataset, capsys):
    labels = predict.main(["--dataID", "0", "--model", "dbda", "--weights",
                           weights_file, "--w", str(W), "--val_batch_size",
                           "64", "--device", "cpu", "--out",
                           str(tmp_path / "map.svg")])
    assert "classified 192 pixels" in capsys.readouterr().out
    cube, _ = synthetic_scene(small_dataset)
    assert _reference_labels_gap(_weights(BANDS), cube, labels) <= TIE
    # the map is the model's, not a constant
    assert len(np.unique(labels)) > 1


def test_dbda_takes_its_own_patch_and_all_bands():
    args = base_parser().parse_args(["--model", "dbda"])
    entry = resolve_model(args, registry.get_dataset(1))
    assert (args.w, args.n_PC, entry.inputs) == (9, 103, "patch")
    args = base_parser().parse_args(["--model", "dbda", "--w", "7"])
    resolve_model(args, registry.get_dataset(1))
    assert (args.w, args.n_PC) == (7, 103)
    # BaseNet2 keeps the CLI's own defaults
    args = base_parser().parse_args([])
    assert resolve_model(args, registry.get_dataset(1)).inputs == "dual"
    assert (args.model, args.w, args.n_PC) == ("basenet2", 20, 60)


@pytest.mark.parametrize("cli", [predict, serve])
@pytest.mark.parametrize("flags,error", [
    (["--checkpoint_dir", "ckpt"], SystemExit),
    (["--weights", "w.npz", "--eval_gather", "dense"], ValueError),
    (["--weights", "w.npz", "--n_PC", "30"], SystemExit),
], ids=["checkpoint_dir", "dense", "n_pc"])
def test_a_zoo_model_refuses_what_it_cannot_map(tmp_path, cli, flags, error):
    with pytest.raises(error, match="--model dbda"):
        cli.main(["--dataID", "0", "--model", "dbda", "--device", "cpu",
                  *flags])


def test_a_zoo_model_refuses_a_basenet2_weights_file(tmp_path):
    path = str(tmp_path / "basenet2.npz")
    save_params_npz(path, init_basenet2_params(0, n_pc=60, num_features=103,
                                               num_classes=9))
    with pytest.raises(ValueError, match="holds no params/ tree"):
        predict.main(["--dataID", "0", "--model", "dbda", "--weights", path,
                      "--device", "cpu"])


def _tile_spans(predictor, scene, profiled):
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            labels = predictor(scene)
    else:
        labels = predictor(scene)
    return labels, [s for s in take_spans() if s.name == "map.tile"]


def test_one_map_tile_span_a_tile_under_a_profiler():
    cube, gt = synthetic_scene(0)
    scene = prepare_scene(0, cube=cube[:12, :12], gt=gt[:12, :12],
                          patch_size=W, n_pc=BANDS, device="cpu")
    model = _model(BANDS, _weights(BANDS))
    predictor = ScenePredictor(lambda xp, x: model(xp), patch_size=W,
                               cols=12, tile=40, spectra=False)
    labels, spans = _tile_spans(predictor, scene, True)
    assert len(spans) == 4                           # 144 pixels, 40 a tile
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))
    again, none = _tile_spans(predictor, scene, False)
    assert none == []
    np.testing.assert_array_equal(labels, again)


@pytest.mark.parametrize("bands,w,classes", [(17, 3, 4), (20, 5, 3),
                                             (BANDS, 9, CLASSES)])
def test_counts_dbda_is_a_brute_force_count(bands, w, classes):
    shapes = ref.shapes(bands, classes)
    p = {k: torch.rand(v) + 0.5 for k, v in shapes.items()}
    with FlopCounterMode(display=False) as count:
        ref.forward(p, torch.randn(1, w, w, bands))
    assert count.get_total_flops() == (
        w * w * counts_dbda.pixel_flops(bands)
        + counts_dbda.patch_flops(w, bands, classes))


@pytest.mark.parametrize("rows,cols,w", [(5, 4, 3), (6, 3, 4), (7, 5, 9)])
def test_covered_pixels_is_the_union_of_the_patches(rows, cols, w):
    h = w // 2 if w % 2 == 0 else (w - 1) // 2
    mask = np.zeros((rows + 2 * h, cols + 2 * h), bool)
    for r in range(rows):
        for c in range(cols):
            mask[r:r + w, c:c + w] = True
    assert counts_dbda.covered_pixels(rows, cols, w) == int(mask.sum())


def test_the_paviau_map_count():
    cfg = dict(rows=610, cols=340, bands=103, classes=9, patch_size=9)
    assert counts_dbda.pixel_flops(103) == 3_498_144
    assert counts_dbda.patch_flops(9, 103, 9) == 5_822_982
    assert counts_dbda.map_flops(cfg) == (618 * 348 * 3_498_144
                                          + 207_400 * 5_822_982)
