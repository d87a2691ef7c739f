"""The supervised-training slice as a whole: the port's
``SupervisedTrainer`` vs ``cmlpl_tpu.train.supervised.SupervisedTrainer``,
its checkpoints, the gather it resolves, and ``cli.train_backbone``, on
the CPU.

Parity protocol (that of ``tests/test_torch_port_train_step.py``): both
packages start from ONE state, the JAX trainer's, carried across by
``supervised_state_from_jax``, and take the same steps on the same
batches (``_schedule`` is a copy of the JAX trainer's) over a 16x14 scene
of 16 bands and 4 classes (12 labeled pixels, batches of 6).  DBDA has
BatchNorm and no dropout; FDSSC's fixed Dropout(0.5) is intercepted on
the JAX side (numpy masks, recorded) and replayed by the port's
``keep_mask``.

Tolerances, those of that file: losses rtol 1e-5 (atol 1e-6 for the
terms near 0), params, batch statistics, Adam moments and the EMA teacher
atol 5e-5 (rtol 1e-4) after 4 steps or a 2-epoch ``fit`` (the measured
worst is under 1e-6), with one exception that the models force.  A conv
bias whose every consumer is a train-mode BatchNorm over its channels
(DBDA's conv11-conv14, FDSSC's conv1-4 and conv6-9) has an exact gradient
of 0: each package computes rounding noise of about 1e-8 instead, and
Adam, which divides a gradient by its own RMS, steps the bias by up to lr
either way.  Such a bias is held to Adam's reach, 2 lr a step, and the
running mean of a BatchNorm it feeds (which the bias shifts) to
(1 - momentum) times that; the measured worst after 4 DBDA steps is 2.1e-3
of a 4e-3 reach and 3.2e-4 of a 4e-4 bound.
"""

import dataclasses
import os

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from cmlpl_tpu.data import generate_splits as jax_generate_splits
from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.eval import ScenePredictor as JaxScenePredictor
from cmlpl_tpu.models.zoo import build_model as jax_build_model
from cmlpl_tpu.ops.patch_gather import resolve_gather_impl as jax_resolve
from cmlpl_tpu.registry import get_dataset as jax_get_dataset
from cmlpl_tpu.train.supervised import SupervisedTrainer as JaxTrainer
from cmlpl_tpu_torch.cli import train_backbone
from cmlpl_tpu_torch.cli._common import run_resilient
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.models.zoo import ZOO
from cmlpl_tpu_torch.ops.patch_gather import resolve_train_gather
from cmlpl_tpu_torch.registry import get_dataset
from cmlpl_tpu_torch.train.supervised import SupervisedTrainer
from cmlpl_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
from cmlpl_tpu_torch.weights import (load_params_npz,
                                     supervised_state_from_jax,
                                     supervised_state_to_jax)
from test_torch_port_zoo import recording_dropout, replay_masks
from torch_port_threads import one_torch_thread  # noqa: F401

W, BANDS, CLASSES, BATCH, EPOCHS = 5, 16, 4, 6, 2
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)
LR = 5e-4
# the conv biases of zero exact gradient (only train-mode BNs read them),
# and the BNs whose running means they shift (momentum 0.9 in both models)
ZERO_GRAD_BIASES = {
    "dbda": ({f"trunk/conv{i}/bias" for i in (11, 12, 13, 14)},
             {f"trunk/bn{i}/mean" for i in (11, 12, 13, 14)}),
    "fdssc": ({f"conv{i}/bias" for i in (1, 2, 3, 4, 6, 7, 8, 9)},
              {f"b{i}_bn/mean" for i in (1, 2, 3, 4, 6, 7, 8, 9)})}


@pytest.fixture(scope="module")
def scenes():
    """(JAX spec, port spec, JAX scene, port scene, train ids, labels)."""
    rng = np.random.default_rng(0)
    gt = rng.integers(1, CLASSES + 1, size=(16, 14))
    cube = (rng.normal(size=(CLASSES + 1, BANDS))[gt] * 2
            + rng.normal(size=(16, 14, BANDS))).astype(np.float32)
    shape = dict(num_classes=CLASSES, num_bands=BANDS)
    jspec = dataclasses.replace(jax_get_dataset(0), **shape)
    spec = dataclasses.replace(get_dataset(0), **shape)
    jscene = jax_prepare_scene(jspec, cube=cube, gt=gt, patch_size=W,
                               n_pc=BANDS)
    scene = prepare_scene(spec, cube=cube, gt=gt, patch_size=W, n_pc=BANDS,
                          device="cpu")
    splits = jax_generate_splits(jscene.labels, num_label=3)
    return jspec, spec, jscene, scene, splits.train, jscene.labels


def _trainers(scenes, name, ema_alpha=0.0, **kw):
    jspec, spec = scenes[:2]
    model, entry = jax_build_model(name, jspec, BANDS)
    jt = JaxTrainer(model, entry, patch_size=W, n_pc=BANDS,
                    num_features=BANDS, donate=False, gather_impl="xla",
                    ema_alpha=ema_alpha, **kw)
    trainer = SupervisedTrainer(name, spec, patch_size=W, n_pc=BANDS,
                                ema_alpha=ema_alpha, device="cpu", **kw)
    return jt, trainer


def _assert_state_close(jstate, state, ema: bool, model: str):
    """Params, batch statistics, Adam moments (and the EMA teacher); the
    zero-gradient biases and the means they shift to Adam's reach."""
    reach = 2 * LR * int(jstate.step)
    biases, means = ZERO_GRAD_BIASES.get(model, (set(), set()))
    got = supervised_state_to_jax(state)
    adam = jstate.opt_state[0]
    pairs = [("params", got["params"], jstate.params),
             ("stats", got["batch_stats"], jstate.batch_stats),
             ("mu", got["opt_state"]["0"]["mu"], adam.mu),
             ("nu", got["opt_state"]["0"]["nu"], adam.nu)]
    if ema:
        pairs.append(("ema", got["ema"], jstate.ema))
    for part, mine, theirs in pairs:
        theirs = jax.device_get(theirs)
        assert (jax.tree_util.tree_structure(mine)
                == jax.tree_util.tree_structure(theirs))
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(mine)[0],
                                jax.tree_util.tree_leaves(theirs)):
            key = "/".join(k.key for k in path)
            tol = dict(PARAM_TOL)
            if part in ("params", "ema") and any(key.endswith(k)
                                                 for k in biases):
                tol["atol"] = reach
            elif part in ("stats", "ema") and any(key.endswith(k)
                                                  for k in means):
                tol["atol"] += (1 - 0.9) * reach
            np.testing.assert_allclose(a, np.asarray(b),
                                       err_msg=f"{part} {key}", **tol)
    assert int(got["opt_state"]["0"]["count"]) == int(adam.count)
    assert state.step == int(jstate.step)


@pytest.mark.parametrize("ema_alpha", [0.0, 0.9])
def test_four_steps_match_jax(scenes, ema_alpha):
    """DBDA (BatchNorm, no dropout): 4 steps of both trainers from the JAX
    trainer's initial state."""
    _, _, jscene, scene, train, labels = scenes
    jt, trainer = _trainers(scenes, "dbda", ema_alpha)
    jstate = jt.init_state(jax.random.key(0))
    state = supervised_state_from_jax(jax.device_get(jstate), trainer)
    li, ly = trainer._schedule(train, labels, BATCH, EPOCHS, None, 3)
    assert li.shape == (4, BATCH)
    for i in range(4):
        jstate, jm = jt.train_step(jstate, jscene, li[i], ly[i])
        state, m = trainer.train_step(state, scene, li[i], ly[i])
        for k in ("cls_loss", "acc"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=f"step {i} {k}", **LOSS_TOL)
    _assert_state_close(jstate, state, ema_alpha > 0, "dbda")


def test_dropout_step_matches_jax_with_the_same_masks(scenes, monkeypatch):
    """FDSSC's Dropout(0.5), which the JAX model cannot turn off: one step
    with the masks JAX drew (recorded by an interceptor), replayed."""
    _, _, jscene, scene, train, labels = scenes
    jt, trainer = _trainers(scenes, "fdssc")
    jstate = jt.init_state(jax.random.key(1))
    state = supervised_state_from_jax(jax.device_get(jstate), trainer)
    li, ly = trainer._schedule(train, labels, BATCH, 1, None, 5)
    masks = []
    with fnn.intercept_methods(recording_dropout(np.random.default_rng(2),
                                                 masks)):
        jstate, jm = jt.train_step(jstate, jscene, li[0], ly[0])
    assert len(masks) == 1 and masks[0].shape == (BATCH, 60)
    pending = replay_masks(monkeypatch, masks)
    state, m = trainer.train_step(state, scene, li[0], ly[0])
    assert not pending
    np.testing.assert_allclose(float(m["cls_loss"]), float(jm["cls_loss"]),
                               **LOSS_TOL)
    _assert_state_close(jstate, state, False, "fdssc")


@pytest.mark.parametrize("ema_alpha", [0.0, 0.9])
def test_fit_matches_jax(scenes, ema_alpha):
    """A whole 2-epoch ``fit`` (the JAX one scanned in one dispatch) from
    one state: the same history and final state."""
    _, _, jscene, scene, train, labels = scenes
    jt, trainer = _trainers(scenes, "dbda", ema_alpha)
    jstate = jt.init_state(jax.random.key(2))
    state = supervised_state_from_jax(jax.device_get(jstate), trainer)
    jlog, log = [], []
    jstate, jhist = jt.fit(jstate, jscene, train, labels, batch_size=BATCH,
                           num_epochs=EPOCHS, log_every=1,
                           log_fn=jlog.append)
    state, hist = trainer.fit(state, scene, train, labels, batch_size=BATCH,
                              num_epochs=EPOCHS, log_every=1,
                              log_fn=log.append)
    assert len(hist) == len(jhist) == 4 and len(log) == len(jlog) == 2
    for m, jm in zip(hist, jhist):
        np.testing.assert_allclose(m["cls_loss"], float(jm["cls_loss"]),
                                   **LOSS_TOL)
    _assert_state_close(jstate, state, ema_alpha > 0, "dbda")


@pytest.mark.parametrize("n,batch,epochs,samples", [
    (12, 6, 3, None), (12, 128, 2, None), (12, 5, 2, 40), (45, 128, 3, 1280),
    (45, 7, 2, None)])
def test_schedule_and_steps_per_epoch_match_jax(scenes, n, batch, epochs,
                                               samples):
    jt, trainer = _trainers(scenes, "basenet2")
    rng = np.random.default_rng(n)
    idx = rng.choice(200, size=n, replace=False)
    labels = rng.integers(1, 10, size=200)
    got = trainer._schedule(idx, labels, batch, epochs, samples, 7)
    want = jt._schedule(idx, labels, batch, epochs, samples, 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (trainer.steps_per_epoch(n, batch, samples)
            == jt.steps_per_epoch(n, batch, samples)
            == got[0].shape[0] // epochs)


def test_checkpoint_resume_equals_an_uninterrupted_fit(scenes, tmp_path):
    """A checkpoint after epoch 1 (augmentations on, so the generator
    matters), restored into a fresh trainer and fit from epoch 1: bitwise
    the state of the run that never stopped; the JAX-layout tree round
    trips."""
    _, _, _, scene, train, labels = scenes
    _, trainer = _trainers(scenes, "dbda", 0.9, augment=True)
    fit = dict(batch_size=BATCH, num_epochs=EPOCHS, log_every=0)
    whole, _ = trainer.fit(trainer.init_state(4), scene, train, labels,
                           **fit)

    def hook(epoch, state):
        if epoch == 0:
            save_checkpoint(str(tmp_path), trainer, state)

    trainer.fit(trainer.init_state(4), scene, train, labels,
                on_epoch_end=hook, **fit)
    resumed = restore_checkpoint(str(tmp_path), trainer)
    assert resumed.step == trainer.steps_per_epoch(len(train), BATCH)
    resumed, _ = trainer.fit(resumed, scene, train, labels, start_epoch=1,
                             **fit)
    a, b = (jax.tree_util.tree_leaves(supervised_state_to_jax(s))
            for s in (whole, resumed))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(whole.generator.get_state(),
                       resumed.generator.get_state())


def test_auto_gather_resolves_per_device(scenes):
    """"auto" with no pool: the plain gather on the CPU, kernel 1 each
    step on the card; "xla" by name stays the plain gather there.  The
    JAX trainer's resolution is "xla"."""
    _, trainer = _trainers(scenes, "dbda")
    assert trainer.gather_impl == "xla"
    shape = dict(num_unlabel=0, patch_size=9, n_pc=103,
                 pool_supported=False)
    cuda = torch.device("cuda")
    assert resolve_train_gather("auto", cuda, **shape) == "pallas"
    assert resolve_train_gather("xla", cuda, **shape) == "xla"
    assert resolve_train_gather("auto", torch.device("cpu"),
                                **shape) == "xla"
    assert jax_resolve("auto", **shape) == "xla"


def test_eval_gather_dense_raises_like_jax(scenes, tmp_path):
    """--eval_gather dense with a zoo model: the JAX CLI hands
    ``ScenePredictor`` ``{"params": ...}`` variables and the dense view
    raises ValueError, even for BaseNet2; so does the port's CLI."""
    jspec = scenes[0]
    rng = np.random.default_rng(1)
    jscene = jax_prepare_scene(
        jspec, cube=rng.normal(size=(12, 10, BANDS)).astype(np.float32),
        gt=rng.integers(1, CLASSES + 1, size=(12, 10)), patch_size=8,
        n_pc=BANDS)
    model, entry = jax_build_model("basenet2", jspec, BANDS)
    jt = JaxTrainer(model, entry, patch_size=8, n_pc=BANDS,
                    num_features=BANDS, donate=False)
    jstate = jt.init_state(jax.random.key(0))
    predictor = JaxScenePredictor(jt.logits_fn(), patch_size=8,
                                  cols=jscene.cols, gather="dense")
    match = "dense eval requires BaseNet2/CCT-shaped params"
    with pytest.raises(ValueError, match=match):
        predictor(jt.eval_variables(jstate), jscene)
    with pytest.raises(ValueError, match=match):
        train_backbone.main(_argv(tmp_path, "basenet2", 1) + [
            "--eval_gather", "dense"])


def _argv(tmp_path, model: str, epochs: int, *extra):
    return ["--dataID", "0", "--model", model, "--num_epochs", str(epochs),
            "--device", "cpu", "--data_root", str(tmp_path),
            "--save_path_prefix", str(tmp_path), "--val_batch_size", "1024",
            *extra]


def test_cli_trains_and_maps_on_the_cpu(tmp_path, capsys):
    """SSFTT at its defaults (w 13, n_PC 5) on the 64x48 synthetic scene:
    2 epochs, an EMA teacher, the metrics CSV, a checkpoint and the
    weights; both maps reported, the SVG and CSV written."""
    ckpt, weights = tmp_path / "ckpt", tmp_path / "w.npz"
    acc = train_backbone.main(_argv(
        tmp_path, "ssftt", 2, "--ema_teacher", "0.9", "--metrics_csv",
        str(tmp_path / "m.csv"), "--checkpoint_dir", str(ckpt),
        "--weights_out", str(weights)))
    out = capsys.readouterr().out
    assert "training time ==" in out and "(2 steps)" in out
    assert "Result (ssftt):" in out and "Result (ssftt EMA teacher):" in out
    assert 0.0 <= acc.oa <= 1.0
    exp = tmp_path / "Experiment_0" / "label_5"
    assert (exp / "ssftt_results.csv").exists()
    assert [p.name for p in exp.glob("ssftt_OA_*.svg")] == [
        f"ssftt_OA_{int(acc.oa * 10000)}.svg"]
    assert len((tmp_path / "m.csv").read_text().splitlines()) == 3
    assert sorted(os.listdir(ckpt)) == ["2"]
    tree = load_params_npz(str(weights))
    assert tree["params"]["conv3d"]["kernel"].shape == (3, 3, 3, 1, 8)
    assert tree["batch_stats"]["bn2d"]["var"].shape == (64,)


def test_cli_restarts_from_its_checkpoint(tmp_path, capsys):
    """A failure injected after epoch 1 of 2, one restart from the epoch-1
    checkpoint (``run_resilient``), resumed at step // steps_per_epoch."""
    argv = _argv(tmp_path, "basenet1", 2, "--checkpoint_dir",
                 str(tmp_path / "ckpt"), "--checkpoint_every", "1",
                 "--fail_at_epoch", "1", "--max_restarts", "1")
    run_resilient(train_backbone.main, argv)
    out = capsys.readouterr().out
    assert "restart 1/1 from the latest checkpoint" in out
    assert "resumed from step 1 (epoch 1)" in out
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "2"]


@pytest.mark.parametrize("model,flags,want", [
    ("dbda", [], (9, 103)), ("msvit", [], (8, 30)), ("basenet2", [], (20, 60)),
    ("ssftt", ["--w", "11"], (11, 5)), ("ssrn", ["--n_PC", "40"], (7, 40))])
def test_cli_takes_the_entry_defaults(model, flags, want):
    args = train_backbone.parser().parse_args(["--model", model, *flags])
    assert train_backbone.entry_shape(args, ZOO[model],
                                      get_dataset(1)) == want


def test_cli_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    argv = [a for a in _argv(tmp_path, "basenet1", 1) if a not in
            ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_backbone.main(argv)


def test_cli_reads_scene_npz_and_splits_dir(tmp_path, capsys):
    """The port's CLI reads --scene_npz and --splits_dir, which the JAX
    CLI accepts and ignores (it always prepares the registry's scene): a
    12x10 scene and a labeled split of 7 pixels, so one step of 7 an
    epoch and a 12x10 class map."""
    rng = np.random.default_rng(3)
    gt = rng.integers(1, 5, size=(12, 10))
    np.savez(tmp_path / "scene.npz", gt=gt,
             cube=rng.normal(size=(12, 10, 103)).astype(np.float32))
    train = np.flatnonzero(gt.reshape(-1))[:7]
    np.save(tmp_path / "train_array.npy", train)
    np.save(tmp_path / "test_array.npy", np.arange(7, 120))
    np.save(tmp_path / "unlabel_array.npy", np.arange(7, 120))
    train_backbone.main(_argv(
        tmp_path, "basenet1", 2, "--scene_npz", str(tmp_path / "scene.npz"),
        "--splits_dir", str(tmp_path), "--print_per_batches", "0"))
    assert "(2 steps)" in capsys.readouterr().out
    svg, = (tmp_path / "Experiment_0" / "label_5").glob("basenet1_OA_*.svg")
    assert 'viewBox="0 0 10 12"' in svg.read_text()
