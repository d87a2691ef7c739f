"""Checkpoints, resume and restarts of the port on the CPU
(``cmlpl_tpu_torch/utils/checkpoint.py``, the checkpoint half of
``cli/_common.py``), against the JAX package's state layout and CLI
semantics (``tests/test_cli.py:155-230``).

A checkpoint is ``<dir>/<step>/state.npz``, the state as a flat
``/``-keyed npz in the JAX package's state layout, and ``generator.npy``.
Its keys are those of the JAX state flattened with numpy alone (fields,
tuple entries, dict keys; the PRNG key left out).  The values after the
same 4 steps agree as the step-parity tests hold them (noise and dropout
off): params within atol 5e-5, the Adam moments and queues within rtol
1e-3 of their tensor's largest entry (f32 sums in another order, through
Adam's division by the root of the second moment), counters exactly.
"""

import argparse
import os

import jax
import numpy as np
import pytest
import torch

from cmlpl_tpu.data import SemiSupervisedSampler as JaxSampler
from cmlpl_tpu.data import generate_splits as jax_generate_splits
from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.train import CCTTrainer as JaxCCTTrainer
from cmlpl_tpu.train import CMLPLConfig as JaxConfig
from cmlpl_tpu.train import CMLPLTrainer as JaxCMLPLTrainer
from cmlpl_tpu.train import CPSTrainer as JaxCPSTrainer
from cmlpl_tpu_torch.cli import train as cli_train
from cmlpl_tpu_torch.cli import train_cct as cli_train_cct
from cmlpl_tpu_torch.cli import train_cps as cli_train_cps
from cmlpl_tpu_torch.cli._common import make_epoch_hook, run_resilient
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.pipeline import SemiSupervisedSampler
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.data.splits import generate_splits
from cmlpl_tpu_torch.train import CCTTrainer, CMLPLTrainer, CPSTrainer
from cmlpl_tpu_torch.train import driver
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.utils.checkpoint import (GENERATOR_FILE, STATE_FILE,
                                              restore_checkpoint,
                                              save_checkpoint)
from cmlpl_tpu_torch.weights import _flatten
from torch_port_threads import one_torch_thread  # noqa: F401

N_PC, W = 16, 20
TINY = dict(num_classes=9, num_features=103, n_pc=N_PC, patch_size=W,
            labeled_batch=8, unlabeled_batch=16, num_unlabel=64,
            num_epochs=2, noise=0.0, dropout=0.0, thr=0.13, queue_batch=1,
            gather_impl="pool")
STEPS = [(0, 0), (0, 2), (1, 0), (1, 1), (1, 2)]   # (epoch, batch index)
TRAINERS = {"cmlpl": (JaxCMLPLTrainer, CMLPLTrainer),
            "cps": (JaxCPSTrainer, CPSTrainer),
            "cct": (JaxCCTTrainer, CCTTrainer)}
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)


def flatten_jax_state(state, prefix=""):
    """(key, array) of a ``jax.device_get`` state with numpy alone:
    NamedTuples by field, tuples by index, dicts by key; the PRNG key, which
    the port does not carry, left out."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        items = [(f, getattr(state, f)) for f in state._fields if f != "rng"]
    elif isinstance(state, (tuple, list)):
        items = list(enumerate(state))
    elif isinstance(state, dict):
        items = list(state.items())
    else:
        yield prefix[:-1], np.asarray(state)
        return
    for k, v in items:
        yield from flatten_jax_state(v, f"{prefix}{k}/")


def write_jax_checkpoint(directory, jstate) -> str:
    """What a JAX user writes from ``jax.device_get(state)``: numpy only."""
    path = os.path.join(directory, str(int(jstate.step)))
    os.makedirs(path)
    np.savez(os.path.join(path, STATE_FILE), **dict(flatten_jax_state(jstate)))
    return path


def _kw(algo, epoch, bi):
    return dict(epoch=epoch, batch_index=bi) if algo == "cmlpl" else {}


def _bitwise_equal(trainer, a, b) -> None:
    ta, tb = (dict(_flatten(trainer.state_to_jax(s))) for s in (a, b))
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and ta[k].shape == tb[k].shape, k
        assert ta[k].tobytes() == tb[k].tobytes(), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.fixture(scope="module")
def scenes():
    cube, gt = synthetic_scene(0)
    return (jax_prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC),
            prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC,
                          device="cpu"))


@pytest.fixture(scope="module", params=list(TRAINERS))
def parity(request, scenes):
    """The JAX trainer's initial state and its state after each of 5
    steps; the port's state carried from the initial one and stepped the
    same 4 steps."""
    algo = request.param
    jscene, scene = scenes
    jcls, cls = TRAINERS[algo]
    jt = jcls(JaxConfig(**TINY), donate=False)
    jstate = jt.init_state(jax.random.key(0))
    trainer = cls(CMLPLConfig(**TINY), device="cpu")
    state = trainer.state_from_jax(jax.device_get(jstate))
    splits = jax_generate_splits(jscene.labels, num_label=5)
    sampler = JaxSampler(splits, jscene.labels, 8, 16, num_unlabel=64, seed=3)
    batches = list(sampler.epoch()) + list(sampler.epoch())   # 4 a epoch
    jstates, jms = [jax.device_get(jstate)], []
    for i, ((epoch, bi), (li, ly, ui)) in enumerate(zip(STEPS, batches)):
        jstate, jm = jt.train_step(jstate, jscene, li, ly, ui,
                                   **_kw(algo, epoch, bi))
        jstates.append(jax.device_get(jstate))
        jms.append({k: float(v) for k, v in jm.items()})
        if i < 4:
            state, _ = trainer.train_step(state, scene, li, ly, ui,
                                          **_kw(algo, epoch, bi))
    return dict(algo=algo, trainer=trainer, state=state, jstates=jstates,
                jms=jms, batches=batches, scene=scene)


# ------------------------------------------------------------ the layout

def test_npz_equals_the_flattened_jax_state(parity, tmp_path):
    trainer, jstates = parity["trainer"], parity["jstates"]
    # the carried initial state is written back bit for bit
    start = trainer.state_from_jax(jstates[0])
    save_checkpoint(str(tmp_path / "a"), trainer, start)
    want = dict(flatten_jax_state(jstates[0]))
    with np.load(tmp_path / "a" / "0" / STATE_FILE) as z:
        assert sorted(z.files) == sorted(want)
        for k in want:
            assert z[k].dtype == want[k].dtype, k
            assert z[k].tobytes() == want[k].tobytes(), k
    # and after the same 4 steps, within the parity tolerances
    path = save_checkpoint(str(tmp_path / "b"), trainer, parity["state"])
    assert os.path.basename(path) == "4"
    want = dict(flatten_jax_state(jstates[4]))
    assert "step" in want and not any("rng" in k for k in want)
    with np.load(os.path.join(path, STATE_FILE)) as z:
        assert sorted(z.files) == sorted(want)
        for k, w in want.items():
            got = z[k]
            assert got.dtype == w.dtype and got.shape == w.shape, k
            if w.dtype.kind == "i":
                np.testing.assert_array_equal(got, w, err_msg=k)
            elif "/params/" in f"/{k}":
                np.testing.assert_allclose(got, w, rtol=1e-4, atol=5e-5,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(
                    got, w, rtol=0, atol=1e-3 * max(np.abs(w).max(), 1e-12),
                    err_msg=k)


def test_port_resumes_a_checkpoint_written_from_a_jax_state(parity,
                                                            tmp_path):
    """A JAX user's npz (no generator file) restores to the state that
    ``*_state_from_jax`` carries, bit for bit, and the 5th step from it
    matches the JAX trainer's 5th step."""
    algo, trainer = parity["algo"], parity["trainer"]
    write_jax_checkpoint(str(tmp_path), parity["jstates"][4])
    state = restore_checkpoint(str(tmp_path), trainer)
    _bitwise_equal(trainer, state,
                   trainer.state_from_jax(parity["jstates"][4]))
    assert state.step == 4
    li, ly, ui = parity["batches"][4]
    epoch, bi = STEPS[4]
    state, m = trainer.train_step(state, parity["scene"], li, ly, ui,
                                  **_kw(algo, epoch, bi))
    for k, v in m.items():
        np.testing.assert_allclose(float(v), parity["jms"][4][k],
                                   err_msg=k, **LOSS_TOL)


# ------------------------------------------------------------ round trips

def _port_trainer(algo, **kw):
    cfg = dict(TINY, noise=0.5, dropout=0.5, thr=0.5, **kw)
    return TRAINERS[algo][1](CMLPLConfig(**cfg), device="cpu")


def _sampler(scene, seed=7):
    splits = generate_splits(scene.labels, num_label=5)
    return SemiSupervisedSampler(splits, scene.labels, 8, 16, 64, seed=seed)


@pytest.mark.parametrize("algo,kw", [
    ("cmlpl", {}), ("cmlpl", {"extra_loss": "memobank"}), ("cps", {}),
    ("cct", {})], ids=["cmlpl", "cmlpl-memobank", "cps", "cct"])
def test_save_and_restore_round_trip_bitwise(scenes, tmp_path, algo, kw):
    """Params, Adam moments and counts, queues, bank, step and generator
    come back bit for bit, and the next step from both states is the
    same step."""
    _, scene = scenes
    trainer = _port_trainer(algo, **kw)
    li, ly, ui = (np.stack(a) for a in zip(*_sampler(scene).epoch()))
    state, _ = trainer.train_epoch(trainer.init_state(3), scene, li[:3],
                                   ly[:3], ui[:3])
    if kw:
        assert int(state.bank.count.sum()) > 0
    save_checkpoint(str(tmp_path), trainer, state, step=2)
    save_checkpoint(str(tmp_path), trainer, state)
    assert sorted(os.listdir(tmp_path)) == ["2", "3"]
    assert sorted(os.listdir(tmp_path / "3")) == [GENERATOR_FILE, STATE_FILE]
    back = restore_checkpoint(str(tmp_path), trainer)     # the largest step
    assert back.step == 3
    _bitwise_equal(trainer, state, back)
    runs = [trainer.train_epoch(s, scene, li[3:], ly[3:], ui[3:], epoch=1)
            for s in (state, back)]
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k
    _bitwise_equal(trainer, runs[0][0], runs[1][0])


def test_restore_without_a_checkpoint_raises(tmp_path):
    trainer = _port_trainer("cps")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "absent"), trainer)
    (tmp_path / "4.tmp").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        restore_checkpoint(str(tmp_path), trainer)


@pytest.mark.parametrize("algo", list(TRAINERS))
def test_resumed_run_equals_the_in_process_continuation(scenes, tmp_path,
                                                        algo):
    """Noise and dropout on.  A run stopped after epoch 1 by the injected
    fault, its checkpoint restored and trained on from epoch 1 with a fresh
    sampler, equals the stopped state trained on in the same process, bit
    for bit; with the hook the pool is gathered once an epoch."""
    _, scene = scenes
    trainer = _port_trainer(algo, num_epochs=3)
    hook = make_epoch_hook(argparse.Namespace(
        checkpoint_dir=str(tmp_path), checkpoint_every=1, fail_at_epoch=1),
        trainer)
    state = trainer.init_state(5)
    with pytest.raises(RuntimeError, match="fault injection"):
        trainer.fit(state, scene, _sampler(scene), log_every=0,
                    on_epoch_end=hook)
    assert state.step == 4 and os.listdir(tmp_path) == ["4"]
    back = restore_checkpoint(str(tmp_path), trainer)
    a, hist_a = trainer.fit(state, scene, _sampler(scene), log_every=0,
                            start_epoch=1)
    b, hist_b = trainer.fit(back, scene, _sampler(scene), log_every=0,
                            start_epoch=1)
    assert len(hist_a) == 8 and hist_a == hist_b
    _bitwise_equal(trainer, a, b)


@pytest.mark.parametrize("hooked", [False, True])
def test_a_hook_gathers_the_pool_once_an_epoch(scenes, monkeypatch, hooked):
    _, scene = scenes
    calls = []
    real = driver.gather_pool
    monkeypatch.setattr(driver, "gather_pool",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    trainer = _port_trainer("cmlpl", num_epochs=3)
    trainer.fit(trainer.init_state(1), scene, _sampler(scene), log_every=0,
                on_epoch_end=(lambda e, s: None) if hooked else None)
    assert len(calls) == (3 if hooked else 1)


# ------------------------------------------------------------ the CLIs

FLAGS = ["--dataID", "0", "--n_PC", str(N_PC), "--num_epochs", "2",
         "--labeled_batch_size", "16", "--unlabeled_batch_size", "16",
         "--num_unlabel", "160", "--val_batch_size", "256", "--dropout",
         "0.5", "--device", "cpu", "--print_per_batches", "0"]


@pytest.mark.parametrize("cli", [cli_train, cli_train_cps, cli_train_cct],
                         ids=["train", "train_cps", "train_cct"])
def test_cli_kill_and_resume(tmp_path, monkeypatch, capsys, cli):
    """1 epoch with a final checkpoint, then a resumed run of 2 epochs:
    it picks up at epoch 1, and trains that epoch only."""
    monkeypatch.chdir(tmp_path)
    one = list(FLAGS)
    one[one.index("--num_epochs") + 1] = "1"
    cli.main(one + ["--checkpoint_dir", "./ckpt"])
    assert os.listdir("ckpt") == ["10"]
    capsys.readouterr()
    result = cli.main(FLAGS + ["--checkpoint_dir", "./ckpt", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 10 (epoch 1)" in out
    assert "(10 steps)" in out
    assert sorted(os.listdir("ckpt")) == ["10", "20"]
    acc = result if cli is cli_train_cct else result[0]
    assert 0.0 <= acc.oa <= 1.0
    # --resume with an empty directory starts fresh
    cli.main(one + ["--checkpoint_dir", "./empty", "--resume"])
    assert "no checkpoint to resume from" in capsys.readouterr().out


def test_cli_elastic_recovery(tmp_path, monkeypatch, capsys):
    """A failure injected after epoch 1's checkpoint propagates without a
    restart budget; with ``--max_restarts 1`` the supervisor retries with
    ``--resume`` and completes the schedule from epoch 1."""
    monkeypatch.chdir(tmp_path)
    args = FLAGS + ["--checkpoint_dir", "./ckpt", "--checkpoint_every", "1",
                    "--fail_at_epoch", "1"]
    with pytest.raises(RuntimeError, match="fault injection"):
        run_resilient(cli_train.main, args)
    capsys.readouterr()
    acc_b, _ = run_resilient(cli_train.main, args + ["--max_restarts", "1"])
    out = capsys.readouterr().out
    assert "restart 1/1 from the latest checkpoint" in out
    assert "resumed from step 10 (epoch 1)" in out
    assert 0.0 <= acc_b.oa <= 1.0
    # without --checkpoint_dir there is nothing to restart from
    with pytest.raises(RuntimeError, match="fault injection"):
        run_resilient(cli_train.main, FLAGS + ["--fail_at_epoch", "1",
                                               "--max_restarts", "1"])
