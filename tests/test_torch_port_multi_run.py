"""Fused multi-seed runs (``EpochDriver.train_multi_run``, ``cli.train
--fused_iters``) on the CPU, against the serial loop and against the JAX
package's fused run (``tests/test_multi_run.py`` holds the JAX one).

The fused run draws each seed's views and dropout masks from that seed's
generator in the serial step's order, so the two runs see the same random
inputs: the generators end bitwise equal, and the first step's losses
agree at the step-parity bounds of ``tests/test_torch_port_train.py``
(rtol 1e-5, atol 1e-6).  The bounds are wider after that, for a stated
reason: the fused step runs each convolution as one grouped convolution
over the seeds and each product as a batched one, which sum in another
order (the step-1 gradients agree to about 5e-6 of each tensor's
largest).  Adam divides each gradient by its own RMS, so a weight whose
gradient lies within that rounding of 0 steps by up to lr = 5e-4 either
way, and the two runs drift apart from there.  Measured over nine seed
and sampler pairs at this size (2 epochs, 8 steps): the metrics within
4e-5 of their size, 0.04% of the weights (of CCT's, at one pair) beyond
half an Adam step, the largest weight gap 1.7e-3.  So every metric is held
at rtol 1e-4, every weight within Adam's reach (lr a step each way), and
at most 0.1% of the weights beyond lr / 2.  A seed that took another
seed's pool, schedule or generator misses these by orders of magnitude.
"""

import jax
import numpy as np
import pytest
import torch

from cmlpl_tpu.data import SemiSupervisedSampler as JaxSampler
from cmlpl_tpu.data import generate_splits as jax_generate_splits
from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.train import CMLPLConfig as JaxConfig
from cmlpl_tpu.train import CMLPLTrainer as JaxTrainer
from cmlpl_tpu_torch.cli import train as cli_train
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.pipeline import SemiSupervisedSampler
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.data.splits import generate_splits
from cmlpl_tpu_torch.ops.patch_gather import poolify_batches
from cmlpl_tpu_torch.train import CCTTrainer, CMLPLTrainer, CPSTrainer
from cmlpl_tpu_torch.train.driver import seed_pools
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.weights import cmlpl_state_from_jax, params_to_jax
from torch_port_threads import one_torch_thread  # noqa: F401

N_PC, W = 16, 20
TINY = dict(num_classes=9, num_features=103, n_pc=N_PC, patch_size=W,
            labeled_batch=8, unlabeled_batch=16, num_unlabel=64,
            num_epochs=2, noise=0.5, dropout=0.5, thr=0.13, queue_batch=1)
FIRST_STEP_TOL = dict(rtol=1e-5, atol=1e-6)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
LR = 5e-4
BEYOND_HALF_STEP_SHARE = 1e-3
TRAINERS = {"cmlpl": CMLPLTrainer, "cps": CPSTrainer, "cct": CCTTrainer}


@pytest.fixture(scope="module")
def tiny():
    cube, gt = synthetic_scene(0)
    scene = prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC,
                          device="cpu")
    return cube, gt, scene, generate_splits(scene.labels, num_label=5)


def _sampler(scene, splits, lb=8, ub=16, num_unlabel=64):
    return SemiSupervisedSampler(splits, scene.labels, lb, ub, num_unlabel,
                                 seed=7)


def _assert_runs_agree(trainer, finals, hists, states, metrics):
    """The serial runs (``finals``, ``hists``) against the fused run's
    ``states`` and (S, E, N) ``metrics``, at the module's bounds."""
    steps = len(hists[0])
    for i, (final, hist) in enumerate(zip(finals, hists)):
        assert torch.equal(final.generator.get_state(),
                           states[i].generator.get_state())
        assert states[i].step == final.step == steps
        for k in hist[0]:
            got = metrics[k][i].reshape(-1).numpy()
            want = np.array([h[k] for h in hist])
            assert got.shape == (steps,)
            np.testing.assert_allclose(got[0], want[0], err_msg=k,
                                       **FIRST_STEP_TOL)
            np.testing.assert_allclose(got, want, err_msg=k, **METRIC_TOL)
        want = trainer.named_params(final)
        got = trainer.named_params(states[i])
        gaps = torch.cat([(got[n] - want[n]).detach().abs().flatten()
                          for n in want])
        assert float(gaps.max()) <= 2 * LR * steps
        assert int((gaps > LR / 2).sum()) <= BEYOND_HALF_STEP_SHARE * len(gaps)


@pytest.mark.parametrize("gather", ["pool", "xla"])
@pytest.mark.parametrize("algo", list(TRAINERS))
def test_fused_equals_the_serial_loop(tiny, algo, gather):
    """Noise and dropout on: 2 seeds, 2 epochs, fused against the serial
    CLI loop (``init_state((seed, i))``, schedules drawn iter-major from
    one sampler)."""
    *_, scene, splits = tiny
    trainer = TRAINERS[algo](CMLPLConfig(**TINY, gather_impl=gather),
                             device="cpu")
    sampler = _sampler(scene, splits)
    finals, hists = zip(*(trainer.fit(trainer.init_state((3, i)), scene,
                                      sampler, log_every=0)
                          for i in range(2)))
    states, metrics = trainer.train_multi_run(3, scene,
                                              _sampler(scene, splits), 2)
    assert len(states) == 2
    assert all(v.shape == (2, 2, 4) for v in metrics.values())
    _assert_runs_agree(trainer, finals, hists, states, metrics)


def test_fused_takes_the_extras_and_views(tiny):
    """Augmentations (all four), an extra objective, binomial fused noise
    views and the stacked forward run fused too, seed by seed as
    serially."""
    *_, scene, splits = tiny
    trainer = CMLPLTrainer(CMLPLConfig(**dict(
        TINY, num_epochs=1, extra_loss="mmd", noise_impl="binom16",
        noise_fused=True, stack_nets=True,
        augment=("flip", "rot90", "radiation", "mixture"))), device="cpu")
    sampler = _sampler(scene, splits)
    finals, hists = zip(*(trainer.fit(trainer.init_state((5, i)), scene,
                                      sampler, log_every=0)
                          for i in range(2)))
    states, metrics = trainer.train_multi_run(5, scene,
                                              _sampler(scene, splits), 2)
    assert "extra_loss" in metrics
    _assert_runs_agree(trainer, finals, hists, states, metrics)
    # the queues carry each seed's rows
    for final, state in zip(finals, states):
        assert state.queue_w.ptr == final.queue_w.ptr
        torch.testing.assert_close(state.queue_s.feats, final.queue_s.feats,
                                   rtol=1e-3, atol=1e-4)


def test_seed_pools_pad_each_pool_with_its_first_id():
    rng = np.random.default_rng(1)
    li = rng.integers(0, 40, (3, 2, 2, 4)).astype(np.int32)
    ui = rng.integers(0, 3000, (3, 2, 2, 8)).astype(np.int32)
    pool, li_pos, ui_pos = seed_pools(li, ui)
    plen = len(pool) // 3
    for i in range(3):
        own, _, _ = poolify_batches(li[i], ui[i])
        block = pool[i * plen:(i + 1) * plen]
        assert np.array_equal(block[:len(own)], own)
        assert (block[len(own):] == own[0]).all()
        np.testing.assert_array_equal(pool[li_pos[i]], li[i])
        np.testing.assert_array_equal(pool[ui_pos[i]], ui[i])
        assert ((li_pos[i] >= i * plen) & (li_pos[i] < (i + 1) * plen)).all()
    one = seed_pools(li[:1], ui[:1])
    for a, b in zip(one, poolify_batches(li[0], ui[0])):
        np.testing.assert_array_equal(a[0] if a.ndim > 1 else a, b)


def test_port_fused_run_matches_the_jax_fused_run(tiny):
    """Noise and dropout off: JAX's ``train_multi_run`` and the port's for
    2 CMLPL seeds from the same initial states (JAX's ``fold_in`` inits,
    carried across by ``cmlpl_state_from_jax``) and the same sampler.  The
    packages sum in other orders (XLA:CPU against oneDNN, and each
    batches the seeds its own way), so the module's bounds, as against
    the serial loop."""
    cube, gt, scene, _ = tiny
    cfg = dict(TINY, unlabeled_batch=8, num_unlabel=48, queue_batch=2,
               noise=0.0, dropout=0.0)
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
        assert states[i].step == int(np.asarray(jstates.step)[i]) == steps


TRAIN_FLAGS = ["--dataID", "0", "--n_PC", str(N_PC), "--num_epochs", "2",
               "--labeled_batch_size", "16", "--unlabeled_batch_size", "16",
               "--num_unlabel", "160", "--val_batch_size", "256",
               "--dropout", "0.5", "--device", "cpu", "--num_iters", "2",
               "--print_per_batches", "0", "--eval_gather", "dense"]


def test_cli_fused_writes_the_serial_results(tmp_path, capsys):
    """``--fused_iters`` writes the serial loop's ``cmlpl_results.csv``
    (the same OAs, both nets, both seeds), one map per seed, seed 0's
    history, and the last seed's weights.  The maps are dense (one pass,
    no gather) to keep the four of each run quick on the CPU."""
    runs = {}
    for mode, extra in (("serial", []), ("fused", ["--fused_iters"])):
        out = tmp_path / mode
        cli_train.main(TRAIN_FLAGS + extra + [
            "--save_path_prefix", str(out), "--metrics_csv",
            str(out / "m.csv"), "--weights_out", str(out / "w.npz")])
        runs[mode] = (out / "Experiment_0" / "label_5", capsys.readouterr())
    (ser, ser_out), (fus, fus_out) = runs["serial"], runs["fused"]
    assert "fused 2-seed training time == " in fus_out.out
    assert "training time ==" in ser_out.out
    assert ((fus / "cmlpl_results.csv").read_text()
            == (ser / "cmlpl_results.csv").read_text())
    assert (sorted(p.name for p in fus.glob("*.svg"))
            == sorted(p.name for p in ser.glob("*.svg")))
    hist = [(tmp_path / m / "m.csv").read_text().splitlines()
            for m in ("serial", "fused")]
    assert hist[0][0] == hist[1][0] and len(hist[1]) == 1 + 20
    with np.load(tmp_path / "serial" / "w.npz") as a, \
            np.load(tmp_path / "fused" / "w.npz") as b:
        for k in a.files:
            assert np.abs(a[k] - b[k]).max() <= 2 * LR * 20, k


@pytest.mark.parametrize("flag", [["--resume"], ["--profile_dir", "p"],
                                  ["--checkpoint_every", "1"]],
                         ids=["resume", "profile_dir", "checkpoint_every"])
def test_cli_fused_refuses_what_jax_refuses(tmp_path, flag):
    with pytest.raises(SystemExit, match="--fused_iters is incompatible"):
        cli_train.main(TRAIN_FLAGS + [
            "--fused_iters", "--checkpoint_dir", str(tmp_path / "ck"),
            "--save_path_prefix", str(tmp_path)] + flag)
