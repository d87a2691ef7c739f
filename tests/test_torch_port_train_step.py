"""The CMLPL training slice as a whole: the port's step vs
``CMLPLTrainer.train_step`` of the JAX package, the driver, the gather
modes and the ``cli.train`` entry point, on the CPU.

Parity protocol (that of ``tests/test_full_step_torch_parity.py``): the
random streams differ (Philox vs threefry), so noise and dropout are off;
both packages start from ONE state, the JAX trainer's, carried across by
``cmlpl_state_from_jax``, and take the same 4 steps on the 64x48 scene at
n_pc 16 with 8 labeled and 16 unlabeled pixels a step.  The 80-row queues
take 24 rows a step, so the 4th write wraps; ``queue_batch`` 1 makes the
steps at (epoch, batch) (0, 2), (1, 0) and (1, 1) smooth with the queues;
``thr`` 0.13 puts the first step's mask rate strictly between 0 and 1.

Tolerances, tighter than that file's (losses rtol 2e-3/atol 2e-4, params
5e-3/5e-4) because they hold: XLA:CPU and oneDNN sum the convolutions in
another order, so losses agree to a few ulp of their size (rtol 1e-5,
atol 1e-5 for the terms near 0) and parameters after 4 Adam steps within
atol 5e-5 (Adam's step is about lr = 5e-4 whatever the gradient's size, so
a gradient near 0 that differs in its last bits moves a weight by up to
that much; the measured worst is under 1e-5).
"""

import os

import jax
import numpy as np
import pytest
import torch

from cmlpl_tpu.data import SemiSupervisedSampler as JaxSampler
from cmlpl_tpu.data import generate_splits as jax_generate_splits
from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.train import CMLPLConfig as JaxConfig
from cmlpl_tpu.train import CMLPLTrainer as JaxTrainer
from cmlpl_tpu_torch.cli import predict
from cmlpl_tpu_torch.cli import train as cli_train
from cmlpl_tpu_torch.cli import train_cct as cli_train_cct
from cmlpl_tpu_torch.cli import train_cps as cli_train_cps
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.pipeline import SemiSupervisedSampler
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.data.splits import generate_splits
from cmlpl_tpu_torch.train.cmlpl import METRICS, CMLPLTrainer
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.weights import (basenet2_params_to_jax,
                                     basenet2_state_dict_from_jax,
                                     cmlpl_state_from_jax)
from torch_port_threads import one_torch_thread  # noqa: F401

N_PC, W = 16, 20
TINY = dict(num_classes=9, num_features=103, n_pc=N_PC, patch_size=W,
            labeled_batch=8, unlabeled_batch=16, num_unlabel=64,
            num_epochs=2, noise=0.0, dropout=0.0, thr=0.13, queue_batch=1)
STEPS = [(0, 0), (0, 2), (1, 0), (1, 1)]   # (epoch, batch index)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)
QUEUE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def scenes():
    cube, gt = synthetic_scene(0)
    return (cube, gt,
            jax_prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC),
            prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC,
                          device="cpu"))


@pytest.fixture(scope="module", params=["xla", "pool"])
def parity(request, scenes):
    """One JAX trainer per gather mode; 4 steps of both packages from the
    JAX trainer's initial state.  Returns the per-step metrics of both,
    the JAX state after each step, and the port's trainer and state."""
    _, _, jscene, scene = scenes
    jt = JaxTrainer(JaxConfig(**TINY, gather_impl=request.param),
                    donate=False)
    jstate = jt.init_state(jax.random.key(0))
    trainer = CMLPLTrainer(CMLPLConfig(**TINY, gather_impl=request.param),
                           device="cpu")
    state = cmlpl_state_from_jax(jax.device_get(jstate), trainer)
    splits = jax_generate_splits(jscene.labels, num_label=5)
    batches = list(JaxSampler(splits, jscene.labels, 8, 16, num_unlabel=64,
                              seed=3).epoch())
    jms, ms, jstates = [], [], []
    for (epoch, bi), (li, ly, ui) in zip(STEPS, batches):
        jstate, jm = jt.train_step(jstate, jscene, li, ly, ui, epoch=epoch,
                                   batch_index=bi)
        state, m = trainer.train_step(state, scene, li, ly, ui, epoch=epoch,
                                      batch_index=bi)
        jms.append({k: float(v) for k, v in jm.items()})
        ms.append({k: float(v) for k, v in m.items()})
        jstates.append(jax.device_get(jstate))
    return dict(mode=request.param, jms=jms, ms=ms, jstates=jstates,
                trainer=trainer, state=state, batches=batches, scene=scene)


def _assert_params_close(tree, state):
    for name in ("net_b", "net_e"):
        want = getattr(tree, name).params
        got = basenet2_params_to_jax(getattr(state, name).model.state_dict())
        for layer in want:
            for leaf in ("kernel", "bias"):
                np.testing.assert_allclose(
                    got[layer][leaf], np.asarray(want[layer][leaf]),
                    err_msg=f"{name}/{layer}/{leaf}", **PARAM_TOL)


def test_step_metrics_match_jax(parity):
    for i, (jm, m) in enumerate(zip(parity["jms"], parity["ms"])):
        assert set(m) == set(jm) == set(METRICS)
        for k in METRICS:
            np.testing.assert_allclose(m[k], jm[k], err_msg=f"step {i} {k}",
                                       **LOSS_TOL)


def test_mask_rate_lies_strictly_between_0_and_1(parity):
    rates = [m["mask_rate"] for m in parity["ms"]]
    assert any(0 < r < 1 for r in rates), rates


def test_params_match_jax_after_4_steps(parity):
    _assert_params_close(parity["jstates"][-1], parity["state"])
    assert parity["state"].step == int(parity["jstates"][-1].step) == 4


def test_queues_match_jax_across_the_wrap(parity):
    tree, state = parity["jstates"][-1], parity["state"]
    for name in ("queue_w", "queue_s"):
        want, got = getattr(tree, name), getattr(state, name)
        assert got.ptr == int(want.ptr) == (4 * 24) % 80
        np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats),
                                   **QUEUE_TOL)
        np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs),
                                   **QUEUE_TOL)


def test_mid_run_state_carries_adam_and_queues(parity):
    """The JAX state after step 2 (Adam count 2, queues half full) carried
    into a fresh port state: the Adam moments land under the params'
    transposes, and step 3 from it matches JAX's step 3."""
    tree = parity["jstates"][1]
    state = cmlpl_state_from_jax(tree, parity["trainer"])
    assert state.step == 2 and state.queue_w.ptr == 48
    adam = tree.net_e.opt_state[0]
    model = state.net_e.model
    mu = basenet2_state_dict_from_jax(adam.mu)
    for key, p in model.named_parameters():
        st = state.net_e.opt.state[p]
        assert float(st["step"]) == 2.0
        assert torch.equal(st["exp_avg"], mu[key])
    li, ly, ui = parity["batches"][2]
    epoch, bi = STEPS[2]
    state, m = parity["trainer"].train_step(state, parity["scene"], li, ly,
                                            ui, epoch=epoch, batch_index=bi)
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), parity["jms"][2][k],
                                   **LOSS_TOL)
    _assert_params_close(parity["jstates"][2], state)


# ------------------------------------------------------------ port only

def _small_trainer(gather, **kw):
    cfg = dict(TINY, noise=0.5, dropout=0.5, thr=0.5, gather_impl=gather)
    cfg.update(kw)
    return CMLPLTrainer(CMLPLConfig(**cfg), device="cpu")


def _params(state):
    return [p.detach().clone() for net in (state.net_b, state.net_e)
            for p in net.model.parameters()]


def test_fit_equals_the_step_loop(scenes):
    """fit draws the whole schedule up front and gathers one pool for the
    run; a loop of train_step draws epoch by epoch and pools each step.
    Same sampler draws, same generator, same values: equal bitwise."""
    _, _, _, scene = scenes
    splits = generate_splits(scene.labels, num_label=5)

    def sampler():
        return SemiSupervisedSampler(splits, scene.labels, 8, 16, 64, seed=7)

    trainer = _small_trainer("pool")
    logs = []
    state, history = trainer.fit(trainer.init_state(11), scene, sampler(),
                                 log_every=2, log_fn=logs.append)
    assert len(history) == 2 * 4 and len(logs) == 2
    assert all(isinstance(v, float) for m in history for v in m.values())

    loop = trainer.init_state(11)
    steps = []
    s = sampler()
    for epoch in range(2):
        for bi, (li, ly, ui) in enumerate(s.epoch()):
            loop, m = trainer.train_step(loop, scene, li, ly, ui, epoch, bi)
            steps.append({k: float(v) for k, v in m.items()})
    assert steps == history
    for a, b in zip(_params(state), _params(loop)):
        assert torch.equal(a, b)
    assert torch.equal(state.queue_s.feats, loop.queue_s.feats)

    # per-epoch calls (an on_epoch_end hook) give the same run too
    seen = []
    hooked, hist2 = trainer.fit(trainer.init_state(11), scene, sampler(),
                                log_every=0,
                                on_epoch_end=lambda e, st: seen.append(e))
    assert seen == [0, 1] and hist2 == history
    for a, b in zip(_params(state), _params(hooked)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("gather", ["pool", "pallas", "pallas_bf16"])
def test_gather_modes_equal_xla_bitwise(scenes, gather):
    """On the CPU every mode gathers the same patch values as "xla" (the
    bf16 kernel's on a bf16-quantised cube), so 3 steps with noise and
    dropout on give the same losses and weights, bit for bit."""
    cube, gt, _, _ = scenes
    scene = prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC,
                          device="cpu")
    if gather == "pallas_bf16":
        scene.padded_pca = scene.padded_pca.to(torch.bfloat16).float()
    splits = generate_splits(scene.labels, num_label=5)
    li, ly, ui = (np.stack(a) for a in zip(*SemiSupervisedSampler(
        splits, scene.labels, 8, 16, 64, seed=2).epoch()))
    runs = {}
    for mode in ("xla", gather):
        trainer = _small_trainer(mode)
        state, m = trainer.train_epoch(trainer.init_state(5), scene,
                                       li[:3], ly[:3], ui[:3], epoch=1)
        runs[mode] = (m, _params(state))
    (m0, p0), (m1, p1) = runs["xla"], runs[gather]
    for k in METRICS:
        assert torch.equal(m0[k], m1[k]), k
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_init_state_is_seeded(scenes):
    trainer = _small_trainer("xla")
    a, b, c = (trainer.init_state(s) for s in ((1, 0), (1, 0), (1, 1)))
    assert all(torch.equal(x, y) for x, y in zip(_params(a), _params(b)))
    assert not torch.equal(_params(a)[0], _params(c)[0])
    assert not torch.equal(_params(a)[0], _params(a)[10])  # B and E differ
    assert torch.equal(torch.rand(4, generator=a.generator),
                       torch.rand(4, generator=b.generator))


TRAIN_FLAGS = ["--dataID", "0", "--n_PC", str(N_PC), "--num_epochs", "2",
               "--labeled_batch_size", "16", "--unlabeled_batch_size", "16",
               "--num_unlabel", "160", "--val_batch_size", "256",
               "--dropout", "0.5", "--device", "cpu"]


def test_cli_train_writes_its_outputs(tmp_path, capsys):
    """The CSVs and the class map, and ``--weights_out`` read back by
    ``cli.predict``: the same net B map (the same SVG, byte for byte) and
    the same OA."""
    weights = str(tmp_path / "w.npz")
    metrics = str(tmp_path / "m.csv")
    acc_b, acc_e = cli_train.main(
        TRAIN_FLAGS + ["--save_path_prefix", str(tmp_path), "--metrics_csv",
                       metrics, "--weights_out", weights, "--num_iters", "2",
                       "--print_per_batches", "5"])
    out = capsys.readouterr().out
    assert out.count("full-scene inference time") == 4
    assert "mean_OA ± std_OA is:" in out and "Epoch 2/2: 10/10" in out
    # the synthetic scene is easy: both nets learn it in 2 epochs
    assert acc_b.oa > 0.9 and acc_e.oa > 0.9

    run_dir = tmp_path / "Experiment_0" / "label_5"
    lines = (run_dir / "cmlpl_results.csv").read_text().splitlines()
    assert lines[0].startswith("OA,OA_std,AA,") and "net_e_OA" in lines[0]
    assert len(lines) == 1 + 9
    rows = open(metrics).read().splitlines()
    assert rows[0] == "step," + ",".join(METRICS) and len(rows) == 1 + 20
    svg = run_dir / f"CMLPL_OA_{int(acc_b.oa * 10000)}.svg"
    assert svg.read_bytes().startswith(b"<svg")

    pred_svg = str(tmp_path / "p.svg")
    predict.main(["--dataID", "0", "--n_PC", str(N_PC), "--val_batch_size",
                  "256", "--weights", weights, "--device", "cpu", "--out",
                  pred_svg])
    assert f"OA={acc_b.oa * 100:.2f}" in capsys.readouterr().out
    assert open(pred_svg, "rb").read() == svg.read_bytes()


@pytest.mark.parametrize("cli", [cli_train, cli_train_cps, cli_train_cct],
                         ids=["train", "train_cps", "train_cct"])
def test_cli_train_needs_the_card_unless_asked(monkeypatch, tmp_path, cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--dataID", "0", "--n_PC", str(N_PC)])
    assert not os.listdir(tmp_path)
