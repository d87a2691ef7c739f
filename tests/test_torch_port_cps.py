"""The CPS slice on the CPU: the port's objective, step, driver, gathers
and ``cli.train_cps`` vs the JAX package's ``CPSTrainer``.

Parity protocol (that of ``tests/test_torch_port_train_step.py``): noise
and dropout off, since Philox is not threefry; both packages start from
ONE state, the JAX trainer's, carried across by ``cps_state_from_jax``, and
take the same 4 steps on the 64x48 scene at n_pc 16 with 8 labeled and 16
unlabeled pixels a step.  Losses agree to rtol 1e-5 (f32 sums in another
order) and weights after 4 Adam steps to atol 5e-5 (a gradient near 0 that
differs in its last bits moves a weight by up to Adam's lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmlpl_tpu.data import SemiSupervisedSampler as JaxSampler
from cmlpl_tpu.data import generate_splits as jax_generate_splits
from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.objectives.cps import \
    cps_cross_supervision as jax_cps_cross_supervision
from cmlpl_tpu.train import CMLPLConfig as JaxConfig
from cmlpl_tpu.train import CPSTrainer as JaxCPSTrainer
from cmlpl_tpu_torch.cli import predict
from cmlpl_tpu_torch.cli import train_cps as cli_train_cps
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.pipeline import SemiSupervisedSampler
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.data.splits import generate_splits
from cmlpl_tpu_torch.objectives.cps import cps_cross_supervision
from cmlpl_tpu_torch.train import CPSTrainer
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.weights import (basenet2_state_dict_from_jax,
                                     cps_state_from_jax, params_to_jax)
from torch_port_threads import one_torch_thread  # noqa: F401

N_PC, W = 16, 20
TINY = dict(num_classes=9, num_features=103, n_pc=N_PC, patch_size=W,
            labeled_batch=8, unlabeled_batch=16, num_unlabel=64,
            num_epochs=2, noise=0.0, dropout=0.0)
METRICS = ("total_loss", "cls_loss", "con_loss", "acc")
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)


@pytest.fixture(scope="module")
def scenes():
    cube, gt = synthetic_scene(0)
    return (cube, gt,
            jax_prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC),
            prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC,
                          device="cpu"))


def test_cross_supervision_matches_jax(rng):
    """Value and gradient; the pseudo-labels carry no gradient."""
    a = rng.normal(size=(12, 9)).astype(np.float32)
    b = rng.normal(size=(12, 9)).astype(np.float32)
    want, (ga, gb) = jax.value_and_grad(jax_cps_cross_supervision,
                                        argnums=(0, 1))(jnp.asarray(a),
                                                        jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    got = cps_cross_supervision(ta, tb)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=1e-6)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=1e-5,
                               atol=1e-7)
    assert tb.grad is None and not np.asarray(gb).any()


@pytest.fixture(scope="module", params=["xla", "pool"])
def parity(request, scenes):
    """4 steps of both packages from the JAX trainer's initial state."""
    _, _, jscene, scene = scenes
    jt = JaxCPSTrainer(JaxConfig(**TINY, gather_impl=request.param),
                       donate=False)
    jstate = jt.init_state(jax.random.key(0))
    trainer = CPSTrainer(CMLPLConfig(**TINY, gather_impl=request.param),
                         device="cpu")
    state = cps_state_from_jax(jax.device_get(jstate), trainer)
    splits = jax_generate_splits(jscene.labels, num_label=5)
    batches = list(JaxSampler(splits, jscene.labels, 8, 16, num_unlabel=64,
                              seed=3).epoch())[:4]
    jms, ms, jstates = [], [], []
    for li, ly, ui in batches:
        jstate, jm = jt.train_step(jstate, jscene, li, ly, ui)
        state, m = trainer.train_step(state, scene, li, ly, ui)
        jms.append({k: float(v) for k, v in jm.items()})
        ms.append({k: float(v) for k, v in m.items()})
        jstates.append(jax.device_get(jstate))
    return dict(jms=jms, ms=ms, jstates=jstates, trainer=trainer,
                state=state, batches=batches, scene=scene)


def _assert_params_close(tree, state):
    for name in ("net_b", "net_e"):
        want = getattr(tree, name).params
        got = params_to_jax(getattr(state, name).model.state_dict())
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
    # the cross term is live: the nets disagree on some unlabeled pixels
    assert all(m["con_loss"] > 0 for m in parity["ms"])


def test_params_match_jax_after_4_steps(parity):
    _assert_params_close(parity["jstates"][-1], parity["state"])
    assert parity["state"].step == int(parity["jstates"][-1].step) == 4


def test_mid_run_state_carries_both_adams(parity):
    """The JAX state after step 2 carried into a fresh port state: step 3
    from it matches JAX's step 3."""
    tree = parity["jstates"][1]
    state = cps_state_from_jax(tree, parity["trainer"])
    assert state.step == 2
    mu = basenet2_state_dict_from_jax(tree.net_b.opt_state[0].mu)
    for key, p in state.net_b.model.named_parameters():
        st = state.net_b.opt.state[p]
        assert float(st["step"]) == 2.0
        assert torch.equal(st["exp_avg"], mu[key])
    li, ly, ui = parity["batches"][2]
    state, m = parity["trainer"].train_step(state, parity["scene"], li, ly,
                                            ui)
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), parity["jms"][2][k],
                                   **LOSS_TOL)
    _assert_params_close(parity["jstates"][2], state)


# ------------------------------------------------------------ port only

def _small_trainer(gather):
    cfg = dict(TINY, noise=0.5, dropout=0.5, gather_impl=gather)
    return CPSTrainer(CMLPLConfig(**cfg), device="cpu")


def _params(state):
    return [p.detach().clone() for net in (state.net_b, state.net_e)
            for p in net.model.parameters()]


def test_fit_equals_the_step_loop(scenes):
    """fit draws the whole schedule up front and gathers one pool for the
    run; a loop of train_step draws epoch by epoch and pools each step:
    same draws, same generator, bitwise equal."""
    _, _, _, scene = scenes
    splits = generate_splits(scene.labels, num_label=5)

    def sampler():
        return SemiSupervisedSampler(splits, scene.labels, 8, 16, 64, seed=7)

    trainer = _small_trainer("pool")
    logs = []
    state, history = trainer.fit(trainer.init_state(11), scene, sampler(),
                                 log_every=2, log_fn=logs.append)
    assert len(history) == 2 * 4 and len(logs) == 2
    assert logs[-1].startswith("Epoch 2/2: 4/4 total_loss=")
    loop = trainer.init_state(11)
    steps = []
    s = sampler()
    for _ in range(2):
        for li, ly, ui in s.epoch():
            loop, m = trainer.train_step(loop, scene, li, ly, ui)
            steps.append({k: float(v) for k, v in m.items()})
    assert steps == history
    assert all(torch.equal(a, b) for a, b in zip(_params(state),
                                                   _params(loop)))


@pytest.mark.parametrize("gather", ["pool", "pallas", "pallas_bf16"])
def test_gather_modes_equal_xla_bitwise(scenes, gather):
    """On the CPU every mode gathers the same patch values as "xla" (the
    bf16 kernel's on a bf16-quantised cube): 3 steps with noise and
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
                                       li[:3], ly[:3], ui[:3])
        runs[mode] = (m, _params(state))
    (m0, p0), (m1, p1) = runs["xla"], runs[gather]
    for k in METRICS:
        assert torch.equal(m0[k], m1[k]), k
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_cli_train_cps_writes_its_outputs(tmp_path, capsys):
    """The CSVs and net B's class map, and ``--weights_out`` read back by
    ``cli.predict``: the same map, byte for byte, and the same OA."""
    weights = str(tmp_path / "w.npz")
    metrics = str(tmp_path / "m.csv")
    acc_b, acc_e = cli_train_cps.main([
        "--dataID", "0", "--n_PC", str(N_PC), "--num_epochs", "2",
        "--labeled_batch_size", "16", "--unlabeled_batch_size", "16",
        "--num_unlabel", "160", "--val_batch_size", "256",
        "--dropout", "0.5", "--device", "cpu", "--num_iters", "3",
        "--save_path_prefix", str(tmp_path), "--metrics_csv", metrics,
        "--weights_out", weights, "--print_per_batches", "5"])
    out = capsys.readouterr().out
    # --num_iters is accepted and ignored, as in the JAX CLI
    assert out.count("training time ==") == 1
    assert "full-scene inference time (net E)" in out
    assert "Epoch 2/2: 10/10" in out and acc_b.oa > 0.9 and acc_e.oa > 0.9

    run_dir = tmp_path / "Experiment_0" / "label_5"
    lines = (run_dir / "cps_results.csv").read_text().splitlines()
    assert lines[0].startswith("OA,OA_std,AA,") and "net_e_OA" in lines[0]
    assert len(lines) == 1 + 9
    rows = open(metrics).read().splitlines()
    assert rows[0] == "step," + ",".join(METRICS) and len(rows) == 1 + 20
    svg = run_dir / f"CPS_OA_{int(acc_b.oa * 10000)}.svg"
    pred_svg = str(tmp_path / "p.svg")
    predict.main(["--dataID", "0", "--n_PC", str(N_PC), "--val_batch_size",
                  "256", "--weights", weights, "--device", "cpu", "--out",
                  pred_svg])
    assert f"OA={acc_b.oa * 100:.2f}" in capsys.readouterr().out
    assert open(pred_svg, "rb").read() == svg.read_bytes()
