"""The CCT slice on the CPU: the port's CCT models, objective, step and
``cli.train_cct`` vs the JAX package's flax models and ``CCTTrainer``.

Models: the same weights, transplanted, on numpy inputs; f32 sums taken
in another order by XLA:CPU and oneDNN: atol 1e-5.

Step parity (the protocol of ``tests/test_torch_port_train_step.py``):
noise off, since Philox is not threefry (CCTNet has no dropout); both
packages start from the JAX trainer's state, carried across by
``cct_state_from_jax``, and take the same 4 steps: losses rtol 1e-5,
params atol 5e-5.  The encoder takes two Adam updates a step, one from
each optimizer: were one missing, its weights would be off by a whole
Adam step (about lr = 5e-4), ten times the tolerance.  The feature-space
perturbations, which parity cannot see, are held by their distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmlpl_tpu.data import SemiSupervisedSampler as JaxSampler
from cmlpl_tpu.data import generate_splits as jax_generate_splits
from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.models.basenet import CCTNet as JaxCCTNet
from cmlpl_tpu.models.basenet import Decoder as JaxDecoder
from cmlpl_tpu.models.basenet import LinearClassifier as JaxLinear
from cmlpl_tpu.objectives.cct import softmax_js_loss as jax_js
from cmlpl_tpu.train import CCTTrainer as JaxCCTTrainer
from cmlpl_tpu.train import CMLPLConfig as JaxConfig
from cmlpl_tpu_torch.cli import train_cct as cli_train_cct
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.data.splits import generate_splits
from cmlpl_tpu_torch.eval.inference import ScenePredictor
from cmlpl_tpu_torch.eval.metrics import cal_accuracy
from cmlpl_tpu_torch.models.basenet import CCTNet, Decoder, LinearClassifier
from cmlpl_tpu_torch.objectives.cct import softmax_js_loss
from cmlpl_tpu_torch.train import CCTTrainer
from cmlpl_tpu_torch.train.cct import cct_logits_fn
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.weights import (cct_state_from_jax, init_cct_params,
                                     load_params_npz, params_to_jax,
                                     save_params_npz, state_dict_from_jax)
from torch_port_threads import one_torch_thread  # noqa: F401

N_PC, W, BANDS, NCLS = 16, 20, 103, 9
JOINT = 64 * (W // 4) ** 2 + 1024
TINY = dict(num_classes=NCLS, num_features=BANDS, n_pc=N_PC, patch_size=W,
            labeled_batch=8, unlabeled_batch=16, num_unlabel=64,
            num_epochs=2, noise=0.0, dropout=0.0)
METRICS = ("total_loss", "cls_loss", "acc")
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def _load(module, params):
    module.load_state_dict(state_dict_from_jax(params))
    return module.eval()


# ------------------------------------------------------------ models

@pytest.mark.parametrize("with_decoder", [False, True])
def test_cctnet_matches_flax(rng, with_decoder):
    xp = rng.normal(size=(5, W, W, N_PC)).astype(np.float32)
    x = rng.normal(size=(5, BANDS)).astype(np.float32)
    jmodel = JaxCCTNet(num_features=BANDS, num_classes=NCLS, n_pc=N_PC,
                       with_decoder=with_decoder)
    params = _np_tree(jmodel.init(jax.random.key(1), jnp.asarray(xp),
                                  jnp.asarray(x))["params"])
    want = jmodel.apply({"params": params}, jnp.asarray(xp), jnp.asarray(x))
    model = _load(CCTNet(num_features=BANDS, dropout=0.8, num_classes=NCLS,
                         n_pc=N_PC, patch_size=W, with_decoder=with_decoder),
                  params)
    model.train()      # no dropout, in training mode too
    with torch.no_grad():
        got = model(torch.from_numpy(xp), torch.from_numpy(x))
    assert len(got) == len(want) == (3 if with_decoder else 2)
    assert got[0].shape == (5, JOINT) and got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **MODEL_TOL)
    assert torch.equal(got[0], got[1])
    if with_decoder:
        for g, w_ in zip(got[2], want[2]):
            assert g.shape == w_.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w_),
                                       **MODEL_TOL)


@pytest.mark.parametrize("patch_size", [20, 8])
def test_decoder_matches_flax(rng, patch_size):
    """Both nearest upsamplings (5 -> 4 -> 20 at w 20; 2 -> 4 -> 8 at w
    8) take the JAX package's index arithmetic."""
    code = rng.normal(size=(3, 256)).astype(np.float32)
    jdec = JaxDecoder(num_features=BANDS, n_pc=N_PC, patch_size=patch_size)
    params = _np_tree(jdec.init(jax.random.key(2), jnp.asarray(code))
                      ["params"])
    want = jdec.apply({"params": params}, jnp.asarray(code))
    dec = _load(Decoder(BANDS, N_PC, patch_size=patch_size), params)
    with torch.no_grad():
        got = dec(torch.from_numpy(code))
    assert got[1].shape == (3, patch_size, patch_size, N_PC)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **MODEL_TOL)


def test_linear_classifier_matches_flax(rng):
    fea = rng.normal(size=(7, JOINT)).astype(np.float32)
    jhead = JaxLinear(NCLS, in_features=JOINT)
    params = _np_tree(jhead.init(jax.random.key(3), jnp.asarray(fea))
                      ["params"])
    head = _load(LinearClassifier(NCLS, in_features=JOINT), params)
    with torch.no_grad():
        got = head(torch.from_numpy(fea))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jhead.apply({"params": params},
                                            jnp.asarray(fea))), **MODEL_TOL)


def test_softmax_js_loss_matches_jax(rng):
    """Value and gradient, with targets that hold exact zeros (0 log 0 is
    0; eps inside the second log); the target takes no gradient."""
    logits = rng.normal(size=(6, NCLS)).astype(np.float32) * 3
    t = rng.dirichlet(np.ones(NCLS), size=6).astype(np.float32)
    t[0] = np.eye(NCLS, dtype=np.float32)[2]
    t[1, :4] = 0
    t[1] /= t[1].sum()
    want, (g_logits, g_t) = jax.value_and_grad(jax_js, argnums=(0, 1))(
        jnp.asarray(logits), jnp.asarray(t))
    tl = torch.from_numpy(logits).requires_grad_()
    tt = torch.from_numpy(t).requires_grad_()
    got = softmax_js_loss(tl, tt)
    got.backward()
    assert np.isfinite(float(want))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(g_logits),
                               rtol=1e-4, atol=1e-7)
    assert tt.grad is None and not np.asarray(g_t).any()


def test_cct_tree_round_trips_through_torch_and_npz(tmp_path):
    """The CCT tree with the decoder (three levels deep under
    ``encoder/decoder``): JAX layout -> state_dict -> JAX layout -> npz ->
    JAX layout, exactly."""
    enc = _np_tree(JaxCCTNet(num_features=BANDS, n_pc=N_PC,
                             with_decoder=True).init(
        jax.random.key(4), jnp.zeros((1, W, W, N_PC)),
        jnp.zeros((1, BANDS)))["params"])
    tree = dict(init_cct_params(1, n_pc=N_PC, num_features=BANDS,
                                num_classes=NCLS, patch_size=W), encoder=enc)
    sd = state_dict_from_jax(tree)
    assert "encoder.decoder.re_conv1.weight" in sd
    path = str(tmp_path / "cct.npz")
    save_params_npz(path, params_to_jax(sd))
    with np.load(path) as z:
        assert "encoder/decoder/re_conv1/kernel" in z.files
    back = load_params_npz(path)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                              jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def test_init_cct_params_has_the_jax_trainers_tree():
    jt = JaxCCTTrainer(JaxConfig(**TINY, gather_impl="xla"), donate=False)
    ref = jax.eval_shape(jt._make_state, jax.random.key(0)).params
    params = init_cct_params(0, n_pc=N_PC, num_features=BANDS,
                             num_classes=NCLS, patch_size=W)
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(ref)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves_with_path(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    fc = params["dec1"]["fc"]["kernel"]
    assert np.abs(fc).max() <= 1 / np.sqrt(JOINT)


# ------------------------------------------------------------ the step

@pytest.fixture(scope="module")
def scenes():
    cube, gt = synthetic_scene(0)
    return (jax_prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC),
            prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC,
                          device="cpu"))


@pytest.fixture(scope="module", params=["xla", "pool"])
def parity(request, scenes):
    """4 steps of both packages from the JAX trainer's initial state."""
    jscene, scene = scenes
    jt = JaxCCTTrainer(JaxConfig(**TINY, gather_impl=request.param),
                       donate=False)
    jstate = jt.init_state(jax.random.key(0))
    trainer = CCTTrainer(CMLPLConfig(**TINY, gather_impl=request.param),
                         device="cpu")
    state = cct_state_from_jax(jax.device_get(jstate), trainer)
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
    got = params_to_jax(state.model.state_dict())
    want = jax.tree_util.tree_leaves_with_path(tree.params)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(tree.params)
    for (path, g), (_, w_) in zip(jax.tree_util.tree_leaves_with_path(got),
                                  want):
        np.testing.assert_allclose(g, np.asarray(w_), err_msg=str(path),
                                   **PARAM_TOL)


def test_step_metrics_match_jax(parity):
    for i, (jm, m) in enumerate(zip(parity["jms"], parity["ms"])):
        assert set(m) == set(jm) == set(METRICS)
        for k in METRICS:
            np.testing.assert_allclose(m[k], jm[k], err_msg=f"step {i} {k}",
                                       **LOSS_TOL)
        # the four JS terms are live
        assert m["total_loss"] > m["cls_loss"]


def test_params_match_jax_after_4_steps(parity):
    _assert_params_close(parity["jstates"][-1], parity["state"])
    assert parity["state"].step == int(parity["jstates"][-1].step) == 4


def test_mid_run_state_carries_both_adams(parity):
    """The JAX state after step 2 carried into a fresh port state: each
    encoder weight has moments in both optimizers, each head's in its
    own, and step 3 from it matches JAX's step 3."""
    tree = parity["jstates"][1]
    state = cct_state_from_jax(tree, parity["trainer"])
    assert state.step == 2
    named = dict(state.model.named_parameters())
    for opt, jopt, heads in ((state.opt_base, tree.opt_base, ("dec_base",)),
                             (state.opt_aug, tree.opt_aug,
                              ("dec1", "dec2"))):
        mu = state_dict_from_jax(jopt[0].mu)
        assert {k.split(".")[0] for k in mu} == {"encoder", *heads}
        assert len(opt.state) == len(mu)
        for key, m in mu.items():
            st = opt.state[named[key]]
            assert float(st["step"]) == 2.0
            assert torch.equal(st["exp_avg"], m)
    li, ly, ui = parity["batches"][2]
    state, m = parity["trainer"].train_step(state, parity["scene"], li, ly,
                                            ui)
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), parity["jms"][2][k],
                                   **LOSS_TOL)
    _assert_params_close(parity["jstates"][2], state)


@pytest.mark.parametrize("noise_impl,noise_fused",
                         [("normal", False), ("binom16", True)])
def test_feature_perturbations_hit_only_unlabeled_features(
        scenes, noise_impl, noise_fused):
    """With noise 0.5 (input views drawn per part or fused): dec_base sees
    the encoder's labeled and unlabeled features unperturbed; dec1 and
    dec2 each see the unlabeled features plus their own draw, of mean 0
    and sd 0.5."""
    _, scene = scenes
    noise = 0.5
    trainer = CCTTrainer(CMLPLConfig(**dict(
        TINY, noise=noise, noise_impl=noise_impl, noise_fused=noise_fused,
        gather_impl="xla")), device="cpu")
    state = trainer.init_state(4)
    seen = {k: [] for k in ("encoder", "dec_base", "dec1", "dec2")}
    hooks = [state.model["encoder"].register_forward_hook(
        lambda mod, args, out: seen["encoder"].append(out[0].detach()))]
    for name in ("dec_base", "dec1", "dec2"):
        hooks.append(state.model[name].register_forward_pre_hook(
            lambda mod, args, name=name: seen[name].append(
                args[0].detach())))
    splits = generate_splits(scene.labels, num_label=5)
    rng = np.random.default_rng(5)
    li = rng.choice(splits.train, 8)
    ui = rng.choice(splits.unlabeled, 16)
    try:
        trainer.train_step(state, scene, li, scene.labels[li] - 1, ui)
    finally:
        for h in hooks:
            h.remove()
    (fea,), (lab, unl), (aug1,), (aug2,) = (seen[k] for k in seen)
    assert torch.equal(lab, fea[:8]) and torch.equal(unl, fea[8:])
    assert aug1.shape == aug2.shape == (16, JOINT)
    d1, d2 = (a - unl for a in (aug1, aug2))
    for d in (d1, d2):
        assert abs(float(d.mean())) < 0.01
        assert abs(float(d.std()) - noise) < 0.01
    corr = float(torch.corrcoef(torch.stack([d1.ravel(), d2.ravel()]))[0, 1])
    assert abs(corr) < 0.02


# ------------------------------------------------------------ the CLI

def test_cli_train_cct_writes_its_outputs(tmp_path, capsys):
    """The CSV of one net, the class map, and ``--weights_out``: the CCT
    tree as a flat npz, which maps the scene to the same OA."""
    weights = str(tmp_path / "cct.npz")
    metrics = str(tmp_path / "m.csv")
    acc = cli_train_cct.main([
        "--dataID", "0", "--n_PC", str(N_PC), "--num_epochs", "2",
        "--labeled_batch_size", "16", "--unlabeled_batch_size", "16",
        "--num_unlabel", "160", "--val_batch_size", "256", "--device",
        "cpu", "--save_path_prefix", str(tmp_path), "--metrics_csv",
        metrics, "--weights_out", weights, "--print_per_batches", "5"])
    out = capsys.readouterr().out
    assert "full-scene inference time (CCT)" in out
    assert "Epoch 2/2: 10/10 total_loss=" in out and acc.oa > 0.9

    run_dir = tmp_path / "Experiment_0" / "label_5"
    lines = (run_dir / "cct_results.csv").read_text().splitlines()
    assert lines[0].startswith("OA,OA_std,AA,") and "net_e" not in lines[0]
    assert len(lines) == 1 + 9
    rows = open(metrics).read().splitlines()
    assert rows[0] == "step," + ",".join(METRICS) and len(rows) == 1 + 20
    assert (run_dir / f"CCT_OA_{int(acc.oa * 10000)}.svg").exists()

    tree = load_params_npz(weights)
    assert sorted(tree) == ["dec1", "dec2", "dec_base", "encoder"]
    trainer = CCTTrainer(CMLPLConfig(**dict(TINY, gather_impl="xla")),
                         device="cpu")
    model = trainer.new_state(tree, 0).model.eval()
    scene = prepare_scene(0, cube=None, gt=None, patch_size=W, n_pc=N_PC,
                          device="cpu")
    pred = ScenePredictor(cct_logits_fn(model), patch_size=W,
                          cols=scene.cols, tile=256)(scene)
    splits = generate_splits(scene.labels, num_label=5)
    assert cal_accuracy(pred[splits.test],
                        scene.labels[splits.test] - 1).oa == acc.oa
