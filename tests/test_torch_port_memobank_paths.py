"""The memory-bank objective (``--extra_loss memobank``) on every path the
JAX package runs it: the serial step, the fused multi-seed run
(``EpochDriver.train_multi_run``, ``cli.train --fused_iters``) and the
exported training run (``utils/export.build_run_exported``,
``cli.export_model --train_bundle``/``--import_run``).

Every draw of a step lives in the trainer's ``_draws``: the bank's three
uniforms (pushed rows, anchors, negatives) are drawn there, after the
views and masks, and the choices are made from them in ``_losses``
(``ops/noise.choose``).  So:

- (a) ``choose`` of a uniform is bit for bit the old ``masked_choice``,
  and ``_losses`` draws nothing; the entropy split's median is
  ``torch.quantile``'s bits and ``jnp.median``'s value;
- (b) a fused memobank run equals the serial loop at
  ``tests/test_torch_port_multi_run.py``'s bounds, the bank too (its
  counts and pointers exactly), with functorch's per-example fallback an
  error;
- (c) it equals the JAX fused run with the bank's choices pinned (both
  packages' samplers replaced by the first admissible index, as in
  ``tests/test_torch_port_extras.py``), noise and dropout off;
- (d) the exported program (``.module()``) is bit for bit its step run
  eagerly (``RunStep``), and the eager trainer's step fed the same
  counter-stream draws;
- (e) the port's step, fed a JAX memobank bundle's inputs, runs from
  JAX's state, bank included, within ``test_full_run_torch_parity``'s
  bounds (choices pinned, noise and dropout off); (d) makes that step
  the program's;
- (f) the CLIs: ``--fused_iters`` writes the serial loop's results, and
  ``--import_run`` carries the bank into ``state.npz``.
"""

import json
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
from cmlpl_tpu.utils.export import build_run_exported as jax_build_run
from cmlpl_tpu_torch.cli import export_model
from cmlpl_tpu_torch.cli import train as cli_train
from cmlpl_tpu_torch.core.rng import CounterStream, uniform
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.patches import gather_patches, gather_spectra
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.data.splits import generate_splits
from cmlpl_tpu_torch.ops.noise import choose, masked_choice
from cmlpl_tpu_torch.train import CMLPLTrainer
from cmlpl_tpu_torch.train.cmlpl import median
from cmlpl_tpu_torch.train.driver import Apply
from cmlpl_tpu_torch.train.functional import RunStep, StateLayout
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.utils.checkpoint import STATE_FILE, restore_checkpoint
from cmlpl_tpu_torch.weights import cmlpl_state_from_jax, params_to_jax
from test_torch_port_extras import _pin_first_choice, _sharpen
from test_torch_port_multi_run import (BEYOND_HALF_STEP_SHARE, LR,
                                       METRIC_TOL, TINY, TRAIN_FLAGS,
                                       _assert_runs_agree, _sampler)
from torch_port_threads import one_torch_thread  # noqa: F401

N_PC, W = 16, 20
MEMO = dict(extra_loss="memobank", extra_weight=0.5)
# functorch's per-example loop where an op has no batching rule
NO_FALLBACK = pytest.mark.filterwarnings("error:There is a performance drop")
# the run bundle's config (tests/test_torch_port_train_bundle.py's, 3
# steps): 1 epoch of 48 unlabeled pixels in batches of 16
BUNDLE_FLAGS = ["--dataID", "0", "--n_PC", "16", "--labeled_batch_size",
                "16", "--unlabeled_batch_size", "16", "--num_epochs", "1",
                "--num_unlabel", "48", "--noise", "0.5", "--dropout", "0.5",
                "--extra_loss", "memobank", "--device", "cpu"]
BUNDLE_SEED = 1088
# tests/test_full_run_torch_parity.py's tolerances
BUNDLE_METRIC_TOL = dict(rtol=5e-3, atol=5e-4)
BUNDLE_PARAM_TOL = dict(rtol=1e-2, atol=1e-3)


@pytest.fixture(scope="module")
def tiny():
    cube, gt = synthetic_scene(0)
    scene = prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC,
                          device="cpu")
    return cube, gt, scene, generate_splits(scene.labels, num_label=5)


def _old_masked_choice(g, mask, n):
    """``masked_choice`` as it was before the draw and the choice split."""
    csum = mask.long().cumsum(-1)
    total = csum[..., -1:]
    u = uniform(g, mask.shape[:-1] + (n,), mask.device)
    k = torch.minimum((u * total).long(), total - 1)
    return torch.searchsorted(csum, k, right=True).clamp(
        max=mask.shape[-1] - 1)


# ------------------------------------------------------ (a) split parity

@pytest.mark.parametrize("source", ["generator", "stream"])
def test_choose_of_a_uniform_is_the_old_masked_choice(source):
    """Rows of 0, 1, some and all true positions, for either draw
    source: the old function, the new ``masked_choice`` and ``choose``
    of a uniform draw give the same indices, bit for bit."""
    mask = torch.rand(6, 40, generator=torch.Generator().manual_seed(0)) < .3
    mask[0] = False
    mask[1] = False
    mask[1, 17] = True
    mask[2] = True

    def src():
        if source == "generator":
            return torch.Generator().manual_seed(5)
        return CounterStream(torch.tensor([3, 4], dtype=torch.uint32), 11)

    want = _old_masked_choice(src(), mask, 300)
    assert torch.equal(masked_choice(src(), mask, 300), want)
    assert torch.equal(choose(uniform(src(), (6, 300), "cpu"), mask), want)
    assert (want[0] == 0).all() and (want[1] == 17).all()
    assert mask.gather(1, want)[1:].all()


def _inputs(scene, li, ui):
    ids = [torch.as_tensor(a, dtype=torch.int32) for a in (li, ui)]
    return [f(i) for i in ids for f in (
        lambda i: gather_patches(scene.padded_pca, i, cols=scene.cols, w=W),
        lambda i: gather_spectra(scene.spectra, i))]


def test_losses_draw_nothing(tiny):
    """A serial memobank step (noise, dropout and every augmentation on):
    after ``_draws``, ``_losses`` leaves the generator and the global
    generator as it found them, and a counter stream's draw count too,
    while the bank's choices are still taken (its counts move)."""
    *_, scene, splits = tiny
    trainer = CMLPLTrainer(CMLPLConfig(**dict(
        TINY, **MEMO, augment=("flip", "rot90", "radiation", "mixture"))),
        device="cpu")
    state = trainer.init_state(4)
    li, ly, ui = next(iter(_sampler(scene, splits).epoch()))
    xp_l, x_l, xp_u, x_u = _inputs(scene, li, ui)
    y = torch.as_tensor(ly, dtype=torch.int64)
    for source in (state.generator,
                   CounterStream(torch.tensor([1, 2]), 0)):
        d = trainer._draws(source, xp_l, x_l, xp_u, x_u, y)
        assert {"bank_push", "bank_anchors", "bank_negatives"} <= set(d)
        mark = (source.get_state() if isinstance(source, torch.Generator)
                else source._draws)
        global_mark = torch.random.get_rng_state()
        _, _, writes = trainer._losses(
            Apply(torch.nn.ModuleDict(trainer._modules(state))), d, y,
            trainer._carry(state), 1, 0)
        if isinstance(source, torch.Generator):
            assert torch.equal(source.get_state(), mark)
        else:
            assert source._draws == mark
        assert torch.equal(torch.random.get_rng_state(), global_mark)
        assert int(writes["bank"].count.sum()) > 0


@pytest.mark.parametrize("case", ["even", "odd", "ties", "flat"])
def test_median_is_quantile_and_jnp_median(case):
    """The entropy split's median: ``torch.quantile(x, 0.5)``'s bits (the
    serial step's before), ``jnp.median``'s value on entropies like the
    step's and on ties, and the same under ``vmap``."""
    rng = np.random.default_rng(2)
    z = rng.normal(size=(4, 128 if case != "odd" else 127, 9)) * 3
    p = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    x = -(p * np.log(p + 1e-10)).sum(-1).astype(np.float32)
    if case == "ties":
        x[:, ::3] = x[:, :1]
        x[:, 1::3] = np.median(x, axis=1, keepdims=True)
    elif case == "flat":
        x[:] = 0.75
    t = torch.from_numpy(x)
    got = torch.func.vmap(median)(t)
    for i in range(4):
        assert torch.equal(median(t[i]), got[i])
        assert torch.equal(got[i], torch.quantile(t[i], 0.5))
        assert got[i].item() == float(jax.numpy.median(x[i]))


# ------------------------------------------------- (b) fused vs serial

@NO_FALLBACK
def test_a_per_example_fallback_is_an_error():
    """The fused tests' filter turns functorch's fallback warning into an
    error: ``torch.quantile``, which the entropy split called before
    :func:`median`, has no batching rule."""
    with pytest.raises(UserWarning, match="performance drop"):
        torch.func.vmap(lambda t: torch.quantile(t, 0.5))(torch.rand(3, 8))


@NO_FALLBACK
def test_fused_memobank_equals_the_serial_loop(tiny):
    """Noise and dropout on: 2 seeds, 2 epochs, fused against the serial
    CLI loop, at the module's bounds; each seed's bank rows within the
    metrics' bounds, its counts and pointers exact."""
    *_, scene, splits = tiny
    trainer = CMLPLTrainer(CMLPLConfig(**TINY, **MEMO, gather_impl="pool"),
                           device="cpu")
    sampler = _sampler(scene, splits)
    finals, hists = zip(*(trainer.fit(trainer.init_state((3, i)), scene,
                                      sampler, log_every=0)
                          for i in range(2)))
    states, metrics = trainer.train_multi_run(3, scene,
                                              _sampler(scene, splits), 2)
    assert "extra_loss" in metrics
    assert float(metrics["extra_loss"].abs().sum()) > 0
    _assert_runs_agree(trainer, finals, hists, states, metrics)
    for final, state in zip(finals, states):
        assert int(final.bank.count.sum()) > 0
        for name in ("count", "ptr"):
            assert torch.equal(getattr(state.bank, name),
                               getattr(final.bank, name)), name
        torch.testing.assert_close(state.bank.feats, final.bank.feats,
                                   **METRIC_TOL)


# ---------------------------------------------------- (c) fused vs JAX

@NO_FALLBACK
def test_port_fused_memobank_matches_the_jax_fused_run(tiny, monkeypatch):
    """Noise and dropout off, the bank's choices pinned: JAX's
    ``train_multi_run`` and the port's for 2 seeds from the same initial
    states (half the steps take the bank's term), at
    ``test_port_fused_run_matches_the_jax_fused_run``'s bounds; the
    banks' counts and pointers equal."""
    _pin_first_choice(monkeypatch)
    cube, gt, scene, _ = tiny
    cfg = dict(TINY, **MEMO, unlabeled_batch=8, num_unlabel=48,
               queue_batch=2, noise=0.0, dropout=0.0)
    jscene = jax_prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC)
    splits = jax_generate_splits(jscene.labels, num_label=5)
    jt = JaxTrainer(JaxConfig(**cfg), donate=False)
    rng = jax.random.key(42)
    jstates, jmetrics = jax.device_get(jt.train_multi_run(
        rng, jscene, JaxSampler(splits, jscene.labels, 8, 8, num_unlabel=48,
                                seed=7), 2))
    trainer = CMLPLTrainer(CMLPLConfig(**cfg, gather_impl="pool"),
                           device="cpu")
    inits = [cmlpl_state_from_jax(jax.device_get(
        jt.init_state(jax.random.fold_in(rng, i))), trainer)
        for i in range(2)]
    states, metrics = trainer.train_multi_run(
        0, scene, _sampler(scene, splits, 8, 8, 48), 2, states=inits)
    steps = 2 * 6
    assert float(np.abs(np.asarray(jmetrics["extra_loss"])).sum()) > 0
    for i in range(2):
        for k in metrics:
            got = metrics[k][i].reshape(-1).numpy()
            want = np.asarray(jmetrics[k][i]).reshape(-1)
            assert got.shape == want.shape == (steps,)
            np.testing.assert_allclose(got[0], want[0], err_msg=k,
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got, want, err_msg=k, **METRIC_TOL)
        gaps = []
        for name in ("net_b", "net_e"):
            got = params_to_jax(getattr(states[i], name).model.state_dict())
            want = getattr(jstates, name).params
            gaps += [np.abs(got[layer][leaf]
                            - np.asarray(want[layer][leaf])[i]).ravel()
                     for layer in want for leaf in want[layer]]
        gaps = np.concatenate(gaps)
        assert gaps.max() <= 2 * LR * steps
        assert (gaps > LR / 2).sum() <= BEYOND_HALF_STEP_SHARE * gaps.size
        for name in ("count", "ptr"):
            np.testing.assert_array_equal(
                getattr(states[i].bank, name).numpy(),
                np.asarray(getattr(jstates.bank, name))[i], err_msg=name)
        assert int(states[i].bank.count.sum()) > 0


# ------------------------------------------------------ the run bundle

@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """``cli.export_model --train_bundle`` of a 3-step memobank run, noise
    and dropout on (its compile replaced by a stand-in that keeps the
    program), and the program's outputs on its inputs."""
    tmp = tmp_path_factory.mktemp("memobank_bundle")
    kept = {}

    def compile_stand_in(exported, package_path):
        kept["program"] = exported
        with open(package_path, "wb") as f:
            f.write(b"stand-in: compiled on the card")
        return package_path

    port_dir = str(tmp / "port")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch._inductor, "aoti_compile_and_package",
                       compile_stand_in)
            export_model.main(BUNDLE_FLAGS + ["--train_bundle", port_dir])
    finally:
        os.chdir(cwd)
    with open(os.path.join(port_dir, "meta.json")) as f:
        meta = json.load(f)
    inputs = [torch.from_numpy(np.load(os.path.join(
        port_dir, "inputs", n + ".npy"))) for n in meta["input_names"]]
    outs = kept["program"].module()(*inputs)
    return {"tmp": tmp, "dir": port_dir, "meta": meta, "inputs": inputs,
            "outs": {n: o for n, o in zip(meta["output_names"], outs)}}


def _bundle_trainer(**overrides):
    return CMLPLTrainer(CMLPLConfig(**dict(dict(
        n_pc=16, labeled_batch=16, unlabeled_batch=16, num_epochs=1,
        num_unlabel=48, noise=0.5, dropout=0.5, extra_loss="memobank",
        gather_impl="pool"), **overrides)), device="cpu")


def _step_loop(step, layout, inputs, cols):
    """``step`` (a ``RunStep``) over every step of a run's inputs, as the
    program's loop runs it; returns (the final tensors, flax layout; the
    metrics of each step)."""
    n = len(layout.leaves)
    tensors = layout.to_torch(inputs[:n])
    padded, spectra, pool, li, ly, ui, thr = inputs[n:]
    xp_src = gather_patches(padded, pool, cols=cols, w=W)
    x_src = gather_spectra(spectra, pool)
    e, b = li.shape[:2]
    history = []
    for i in range(e * b):
        ep, bi = divmod(i, b)
        tensors, m = step(tensors, xp_src, x_src, li[ep, bi], ly[ep, bi],
                          ui[ep, bi], torch.tensor(ep), torch.tensor(bi),
                          thr[ep])
        history.append(m)
    return layout.to_jax(tensors), history


def test_exported_memobank_run_is_its_step_and_the_eager_step(bundle, tiny):
    """(d) Noise and dropout on: the program's outputs are its step looped
    eagerly, and the eager trainer's steps (in-place Adam, queues and
    bank) fed each step's counter-stream draws, bit for bit; the bank
    carries state across the steps."""
    *_, scene, _ = tiny
    meta, inputs, outs = bundle["meta"], bundle["inputs"], bundle["outs"]
    trainer = _bundle_trainer()
    state = trainer.init_state((BUNDLE_SEED, 0))
    key = inputs[meta["input_names"].index("state.rng")]
    layout = StateLayout(trainer, state, key.numpy())
    assert layout.names == meta["input_names"][:len(layout.leaves)]
    assert [lf.kind for lf in layout.leaves
            if lf.name.startswith("state.bank.")] == ["bank"] * 3
    want, _ = _step_loop(RunStep(trainer, state, layout), layout, inputs,
                         scene.cols)
    for name, value in zip(layout.names, want):
        assert torch.equal(outs[name], value), name

    n = len(layout.leaves)
    padded, spectra, pool, li, ly, ui, thr = inputs[n:]
    xp_src = gather_patches(padded, pool, cols=scene.cols, w=W)
    x_src = gather_spectra(spectra, pool)
    apply = Apply(torch.nn.ModuleDict(trainer._modules(state)))
    losses = []
    for i in range(li.shape[1]):
        g = CounterStream(key, i)
        args = [src.index_select(0, ids[0, i]) for ids in (li, ui)
                for src in (xp_src, x_src)]
        xp_l, x_l, xp_u, x_u = args
        y = ly[0, i].long()
        d = trainer._draws(g, xp_l, x_l, xp_u, x_u, y)
        carry = trainer._carry(state)
        loss, m, writes = trainer._losses(apply, d, y, carry, 0, i, thr[0])
        trainer._update(state, loss, *trainer._opts(state))
        trainer._write(carry, writes)
        losses.append(m["total_loss"])
    eager = StateLayout(trainer, state, key.numpy())
    for name, value in zip(eager.names, eager.values):
        assert np.array_equal(outs[name].numpy(), value), name
    assert torch.equal(outs["metrics.total_loss"].reshape(-1),
                       torch.stack(losses))
    assert int(outs["state.bank.count"].sum()) > 0
    assert float(outs["metrics.extra_loss"].abs().sum()) > 0


def test_cli_import_run_carries_the_bank(bundle):
    """(f) ``--import_run`` writes the bank into ``state.npz`` under the
    checkpoint's keys, and a restore holds the run's bank."""
    tmp = bundle["tmp"]
    outdir, ck = tmp / "out", tmp / "ck"
    outdir.mkdir()
    for name, value in bundle["outs"].items():
        np.save(outdir / (name + ".npy"), value.numpy())
    export_model.main(BUNDLE_FLAGS + [
        "--import_run", bundle["dir"], str(outdir), "--checkpoint_dir",
        str(ck)])
    with np.load(ck / "3" / STATE_FILE) as z:
        for name in ("feats", "count", "ptr"):
            np.testing.assert_array_equal(
                z[f"bank/{name}"], bundle["outs"][f"state.bank.{name}"])
    restored = restore_checkpoint(str(ck), _bundle_trainer())
    assert restored.step == 3
    for name in ("feats", "count", "ptr"):
        assert torch.equal(getattr(restored.bank, name),
                           bundle["outs"][f"state.bank.{name}"]), name


def test_port_step_on_jax_memobank_bundle_inputs_matches_jax(bundle, tiny,
                                                             monkeypatch):
    """(e) Noise and dropout off, choices pinned, net E sharpened so that
    its 3 steps take the bank's term: the JAX memobank bundle's program
    on its inputs against the port's step looped over the same inputs
    (its signature's names are the port bundle's), every output by name
    within ``test_full_run_torch_parity``'s bounds, the integers
    exact."""
    _pin_first_choice(monkeypatch)
    cube, gt, scene, _ = tiny
    cfg = dict(n_pc=16, labeled_batch=16, unlabeled_batch=16, num_epochs=1,
               num_unlabel=48, noise=0.0, dropout=0.0, **MEMO)
    jscene = jax_prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC)
    jsplits = jax_generate_splits(jscene.labels, num_label=5)
    jt = JaxTrainer(JaxConfig(**cfg))
    make_state = jt._make_state
    monkeypatch.setattr(jt, "_make_state", lambda k: _sharpen(make_state(k)))
    meta, exported, inputs = jax_build_run(
        jt, jscene, JaxSampler(jsplits, jscene.labels, 16, 16,
                               num_unlabel=48, seed=BUNDLE_SEED),
        jax.random.fold_in(jax.random.key(BUNDLE_SEED), 0),
        platforms=["cpu"])
    assert meta["input_names"] == bundle["meta"]["input_names"]
    assert meta["output_names"] == bundle["meta"]["output_names"]
    jax_out = dict(zip(meta["output_names"],
                       jax.jit(exported.call)(*inputs.values())))

    trainer = _bundle_trainer(noise=0.0, dropout=0.0, extra_weight=0.5)
    args = [torch.from_numpy(np.array(v)) for v in inputs.values()]
    layout = StateLayout(trainer, trainer.init_state(0),
                         inputs["state.rng"])
    final, history = _step_loop(RunStep(trainer, trainer.init_state(0),
                                        layout), layout, args, scene.cols)
    got = dict(zip(layout.names, final))
    got.update({f"metrics.{k}": torch.stack([m[k] for m in history])
                .reshape(1, -1) for k in history[0]})
    assert sorted(got) == sorted(meta["output_names"])
    assert float(np.abs(np.asarray(jax_out["metrics.extra_loss"])).sum()) > 0
    for name in meta["output_names"]:
        g, w = got[name].numpy(), np.asarray(jax_out[name])
        assert g.shape == w.shape, name
        if name.startswith("metrics."):
            np.testing.assert_allclose(g, w, err_msg=name,
                                       **BUNDLE_METRIC_TOL)
        elif g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, err_msg=name,
                                       **BUNDLE_PARAM_TOL)
        elif name != "state.rng":
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(got["state.bank.count"].sum()) > 0


# ---------------------------------------------------------------- (f) CLI

def test_cli_fused_memobank_writes_the_serial_results(tmp_path, capsys):
    """``cli.train --fused_iters --num_iters 2 --extra_loss memobank``
    writes the serial loop's ``cmlpl_results.csv``."""
    csvs = {}
    for mode, extra in (("serial", []), ("fused", ["--fused_iters"])):
        out = tmp_path / mode
        cli_train.main(TRAIN_FLAGS + extra + [
            "--num_epochs", "1", "--num_unlabel", "64", "--extra_loss",
            "memobank", "--save_path_prefix", str(out)])
        csvs[mode] = (out / "Experiment_0" / "label_5"
                      / "cmlpl_results.csv").read_text()
    assert "fused 2-seed training time == " in capsys.readouterr().out
    assert csvs["fused"] == csvs["serial"]
