"""The training slice's host code, gather plumbing, noise, objectives and
queue: the port vs the JAX package on the same inputs, made with numpy.

Host code (splits, sampler, schedule, pools, the gather resolution) is a
copy and must be equal.  The objectives and the queue are held by value
and gradient at rtol 1e-5: f32 sums taken in another order by XLA:CPU and
PyTorch's CPU kernels differ in the last bits only.  The noise views are
held by their distribution, since Philox is not threefry.
"""

import argparse
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmlpl_tpu.cli._common import save_history as jax_save_history
from cmlpl_tpu.data import SemiSupervisedSampler as JaxSampler
from cmlpl_tpu.data import load_splits as jax_load_splits
from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.eval.metrics import Accuracy as JaxAccuracy
from cmlpl_tpu.eval.report import save_report as jax_save_report
from cmlpl_tpu.eval.validation import validation_accuracy as jax_validation
from cmlpl_tpu.models import BaseNet2 as JaxBaseNet2
from cmlpl_tpu.objectives import cmlpl as jax_cmlpl
from cmlpl_tpu.objectives import queue as jax_queue
from cmlpl_tpu.objectives.supervised import cross_entropy as jax_ce
from cmlpl_tpu.ops import noise as jax_noise
from cmlpl_tpu.ops import patch_gather as jax_pg
from cmlpl_tpu.train.driver import stack_schedule as jax_stack_schedule
from cmlpl_tpu_torch.cli._common import save_history
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.pipeline import SemiSupervisedSampler
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.data.splits import generate_splits, load_splits
from cmlpl_tpu_torch.eval.metrics import Accuracy
from cmlpl_tpu_torch.eval.report import save_report
from cmlpl_tpu_torch.eval.validation import validation_accuracy
from cmlpl_tpu_torch.models.basenet import BaseNet2, dropout
from cmlpl_tpu_torch.objectives.cmlpl import (adaptive_threshold,
                                              graph_contrastive,
                                              pseudo_label_graph,
                                              soft_consistency)
from cmlpl_tpu_torch.objectives.queue import (QueueState, memory_smooth,
                                              queue_update)
from cmlpl_tpu_torch.objectives.supervised import cross_entropy
from cmlpl_tpu_torch.ops import patch_gather as pg
from cmlpl_tpu_torch.ops.noise import make_noiser, popcount16, two_net_views
from cmlpl_tpu_torch.train.cmlpl import CMLPLTrainer
from cmlpl_tpu_torch.train.driver import stack_schedule
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.weights import (basenet2_params_to_jax,
                                     basenet2_state_dict_from_jax,
                                     init_basenet2_params)
from torch_port_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def tiny():
    cube, gt = synthetic_scene(0)
    labels = gt.reshape(-1).astype(np.int32)
    return cube, gt, labels, generate_splits(labels, num_label=5)


# ---------------------------------------------------------------- host data

@pytest.mark.parametrize("lb,ub,num_unlabel", [(128, 128, 10000),
                                               (8, 16, 64), (5, 7, 100)])
def test_sampler_batches_equal(tiny, lb, ub, num_unlabel):
    *_, labels, splits = tiny
    got = SemiSupervisedSampler(splits, labels, lb, ub, num_unlabel, seed=5)
    want = JaxSampler(splits, labels, lb, ub, num_unlabel, seed=5)
    assert got.batches_per_epoch == want.batches_per_epoch
    if num_unlabel == 10000:
        assert got.batches_per_epoch == 78   # the drop-last of the defaults
    for _ in range(3):
        for g, w in itertools.zip_longest(got.epoch(), want.epoch()):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_stack_schedule_equal(tiny):
    *_, labels, splits = tiny
    got = stack_schedule(SemiSupervisedSampler(splits, labels, 8, 16, 64,
                                               seed=1), 3)
    want = jax_stack_schedule(JaxSampler(splits, labels, 8, 16, 64, seed=1),
                              3)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.shape[:2] == (3, 4)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("shape,bucket", [((4,), 512), ((3, 8), 512),
                                          ((2, 5, 16), 16), ((1, 1, 8), 4)])
def test_poolify_batches_equal(rng, shape, bucket):
    li = rng.integers(0, 300, shape).astype(np.int32)
    ui = rng.integers(0, 3000, shape[:-1] + (2 * shape[-1],)).astype(np.int32)
    got = pg.poolify_batches(li, ui, bucket)
    want = jax_pg.poolify_batches(li, ui, bucket)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    pool, li_pos, ui_pos = got
    assert len(pool) % bucket == 0
    np.testing.assert_array_equal(pool[li_pos], li)
    np.testing.assert_array_equal(pool[ui_pos], ui)


@pytest.mark.parametrize("impl,num_unlabel,width", itertools.product(
    ["auto", "xla", "pool", "pallas"], [10000, 60000], [(20, 60), (9, 30)]))
def test_resolve_gather_impl_equal(impl, num_unlabel, width):
    patch_size, n_pc = width
    kw = dict(num_unlabel=num_unlabel, patch_size=patch_size, n_pc=n_pc,
              num_labeled=45)
    got = pg.resolve_gather_impl(impl, **kw)
    assert got == jax_pg.resolve_gather_impl(impl, **kw)
    if impl == "auto":
        # 10,045 uniques -> 10,240 rows of 96 kB: 0.98 GB under 2 GiB;
        # 60,416 rows are 5.8 GB at w 20 / n_PC 60 and 0.59 GB at 9 / 30
        assert got == ("xla" if (num_unlabel, width) == (60000, (20, 60))
                       else "pool")


@pytest.mark.parametrize("impl,num_unlabel,device", itertools.product(
    ["auto", "xla"], [10000, 60000], ["cpu", "cuda"]))
def test_resolve_train_gather(impl, num_unlabel, device):
    """An over-budget "auto" takes kernel 1 per step on the card and the
    plain gather on the CPU; "xla" by name stays "xla"."""
    kw = dict(num_unlabel=num_unlabel, patch_size=20, n_pc=60,
              num_labeled=45)
    got = pg.resolve_train_gather(impl, torch.device(device), **kw)
    assert got == {("auto", 10000): "pool",
                   ("auto", 60000): "pallas" if device == "cuda" else "xla",
                   ("xla", 10000): "xla", ("xla", 60000): "xla"}[
                       impl, num_unlabel]


def test_train_gather_knobs():
    assert pg.POOL_AUTO_BUDGET_BYTES == jax_pg.POOL_AUTO_BUDGET_BYTES
    assert pg.POOL_BUCKET == jax_pg.POOL_BUCKET
    for impl in ("pool", "dense"):
        with pytest.raises(ValueError, match="unknown per-step"):
            pg.make_train_gather(impl, 16)
    with pytest.raises(ValueError, match="input_dtype"):
        CMLPLTrainer(CMLPLConfig(input_dtype="float16"), device="cpu")


def test_load_splits_equal(tiny, tmp_path):
    *_, splits = tiny
    for name, arr in (("train", splits.train), ("test", splits.test),
                      ("unlabel", splits.unlabeled)):
        np.save(tmp_path / f"{name}_array.npy", arr[:, None])
    got, want = load_splits(str(tmp_path)), jax_load_splits(str(tmp_path))
    for name in ("train", "test", "unlabeled"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        np.testing.assert_array_equal(a, getattr(splits, name))


# -------------------------------------------------------------- objectives

def _value_and_grads(jax_fn, torch_fn, args, diff):
    """Value of fn(*args) and its grads wrt the args at ``diff``, from both
    packages; a non-scalar output is reduced against fixed weights."""
    rng = np.random.default_rng(9)

    def reduce_(out, lib):
        outs = out if isinstance(out, tuple) else (out,)
        weights = [rng.normal(size=np.shape(o)).astype(np.float32)
                   for o in outs]
        if lib is jnp:
            return sum(jnp.sum(o * w) for o, w in zip(outs, weights))
        return sum((o * torch.from_numpy(w)).sum()
                   for o, w in zip(outs, weights))

    jargs = [jnp.asarray(a) for a in args]
    jval, jgrads = jax.value_and_grad(
        lambda *a: reduce_(jax_fn(*a), jnp), argnums=diff)(*jargs)
    rng = np.random.default_rng(9)
    targs = [torch.tensor(a, requires_grad=i in diff)
             for i, a in enumerate(args)]
    tval = reduce_(torch_fn(*targs), torch)
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=RTOL,
                               atol=ATOL)
    for i, jg in zip(diff, jgrads):
        np.testing.assert_allclose(targs[i].grad.numpy(), np.asarray(jg),
                                   rtol=RTOL, atol=ATOL)


def _probs(rng, n, c, sharp):
    z = rng.normal(size=(n, c)) * sharp
    p = np.exp(z - z.max(1, keepdims=True))
    return (p / p.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("ignored", [0, 3, 12])
def test_cross_entropy_value_and_grad(rng, ignored):
    logits = rng.normal(size=(12, 9)).astype(np.float32) * 3
    labels = rng.integers(0, 9, 12).astype(np.int32)
    labels[:ignored] = -1
    _value_and_grads(lambda x, y: jax_ce(x, y),
                     lambda x, y: cross_entropy(x, y.long()),
                     [logits, labels], diff=(0,))


def test_soft_consistency_value_and_grad(rng):
    logits = rng.normal(size=(16, 9)).astype(np.float32) * 2
    probs = _probs(rng, 16, 9, 3.0)
    mask = (rng.random(16) < 0.6).astype(np.float32)
    _value_and_grads(jax_cmlpl.soft_consistency, soft_consistency,
                     [logits, probs, mask], diff=(0, 1))
    # the mean divides by the batch, not by mask.sum()
    got = soft_consistency(torch.from_numpy(logits), torch.from_numpy(probs),
                           torch.from_numpy(mask))
    per = -(torch.log_softmax(torch.from_numpy(logits), 1)
            * torch.from_numpy(probs)).sum(1) * torch.from_numpy(mask)
    assert torch.allclose(got, per.sum() / 16)


@pytest.mark.parametrize("sharp", [1.0, 6.0])
def test_pseudo_label_graph_value_and_grad(rng, sharp):
    """Sharp probabilities put entries on both sides of 0.8 and 0.3, so
    both the positive and the negative graph carry weight."""
    p_row, p_col = _probs(rng, 16, 9, sharp), _probs(rng, 16, 9, sharp)
    _value_and_grads(jax_cmlpl.pseudo_label_graph, pseudo_label_graph,
                     [p_row, p_col], diff=(0, 1))
    q, qn = pseudo_label_graph(torch.from_numpy(p_row),
                               torch.from_numpy(p_col))
    assert torch.allclose(q.sum(1), torch.ones(16))
    if sharp > 1:
        assert ((q > 0).sum(1) > 1).any() and (qn > 0).any()


def test_graph_contrastive_value_and_grad(rng):
    f_row = rng.normal(size=(16, 32)).astype(np.float32)
    f_col = rng.normal(size=(16, 32)).astype(np.float32)
    f_row /= np.linalg.norm(f_row, axis=1, keepdims=True)
    f_col /= np.linalg.norm(f_col, axis=1, keepdims=True)
    q, qn = (np.asarray(a) for a in jax_cmlpl.pseudo_label_graph(
        jnp.asarray(_probs(rng, 16, 9, 6.0)),
        jnp.asarray(_probs(rng, 16, 9, 6.0))))
    _value_and_grads(
        lambda a, b, c, d: jax_cmlpl.graph_contrastive(a, b, c, d, 0.3),
        lambda a, b, c, d: graph_contrastive(a, b, c, d, 0.3),
        [f_row, f_col, q, qn], diff=(0, 1))


@pytest.mark.parametrize("epoch", [0, 1, 7, 19])
def test_adaptive_threshold_equal_to_the_trainers(epoch):
    got = adaptive_threshold(epoch, 20, 0.9)
    want = np.float32(float(np.exp(-0.5 * (epoch / 20) ** 2)) * 0.9)
    assert got == float(want)
    np.testing.assert_allclose(
        got, float(jax_cmlpl.adaptive_threshold(jnp.float32(epoch), 20,
                                                0.9)), rtol=1e-6)


# ------------------------------------------------------------------- queue

def _queue(rng, size=40, dim=24, ncls=9, ptr=0):
    feats = rng.normal(size=(size, dim)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    probs = _probs(rng, size, ncls, 2.0)
    return feats, probs, ptr


def test_memory_smooth_equal(rng):
    feats, probs_q, _ = _queue(rng)
    x = rng.normal(size=(12, 24)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    p = _probs(rng, 12, 9, 2.0)
    want = jax_queue.memory_smooth(
        jnp.asarray(x), jnp.asarray(p),
        jax_queue.QueueState(jnp.asarray(feats), jnp.asarray(probs_q),
                             jnp.int32(0)), 0.95, 0.3)
    got = memory_smooth(torch.from_numpy(x), torch.from_numpy(p),
                        QueueState(torch.from_numpy(feats),
                                   torch.from_numpy(probs_q), 0), 0.95, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("ptr,n", [(0, 12), (30, 12), (35, 5), (3, 40)])
def test_queue_update_equal_across_the_wrap(rng, ptr, n):
    feats, probs, _ = _queue(rng)
    new_f = rng.normal(size=(n, 24)).astype(np.float32)
    new_p = _probs(rng, n, 9, 1.0)
    want = jax_queue.queue_update(
        jax_queue.QueueState(jnp.asarray(feats), jnp.asarray(probs),
                             jnp.int32(ptr)),
        jnp.asarray(new_f), jnp.asarray(new_p))
    q = QueueState(torch.from_numpy(feats.copy()),
                   torch.from_numpy(probs.copy()), ptr)
    queue_update(q, torch.from_numpy(new_f), torch.from_numpy(new_p))
    assert q.ptr == int(want.ptr)
    np.testing.assert_array_equal(q.feats.numpy(), np.asarray(want.feats))
    np.testing.assert_array_equal(q.probs.numpy(), np.asarray(want.probs))


# ------------------------------------------------------------------- noise

def test_popcount16_is_exact():
    x = torch.arange(1 << 16, dtype=torch.int32)
    want = torch.tensor([bin(i).count("1") for i in range(1 << 16)],
                        dtype=torch.int32)
    assert torch.equal(popcount16(x), want)


@pytest.mark.parametrize("impl", ["normal", "binom16"])
def test_noise_mean_and_variance(impl):
    """n = 2**20 draws: the sample mean's sd is 1e-3, the sample
    variance's about 1.4e-3 (normal; binom16's kurtosis is lower)."""
    g = torch.Generator().manual_seed(0)
    a = torch.full((1 << 20,), 3.0)
    noise = (make_noiser(impl, 0.5)(g, a) - 3.0) / 0.5
    assert abs(float(noise.mean())) < 5e-3
    assert abs(float(noise.var()) - 1.0) < 1e-2
    # the JAX package's sampler has the same two moments
    jn = np.asarray(jax_noise.make_noiser(impl, 1.0)(
        jax.random.key(0), jnp.zeros((1 << 20,))))
    assert abs(jn.mean()) < 5e-3 and abs(jn.var() - 1.0) < 1e-2


def test_binom16_lattice():
    """binom16 takes exactly the 17 values (k - 8) / 2, k = 0..16, with
    Binomial(16, 1/2) frequencies, like the JAX sampler."""
    from math import comb

    g = torch.Generator().manual_seed(1)
    n = 1 << 20
    v = make_noiser("binom16", 1.0)(g, torch.zeros(n))
    k = v * 2 + 8
    assert torch.equal(k, k.round()) and k.min() >= 0 and k.max() <= 16
    freq = torch.bincount(k.long(), minlength=17).double() / n
    pmf = torch.tensor([comb(16, i) / 2 ** 16 for i in range(17)],
                       dtype=torch.float64)
    # 5 sd of a binomial proportion at n = 2**20
    assert ((freq - pmf).abs() <= 5 * (pmf * (1 - pmf) / n).sqrt()
            + 1e-9).all()
    jv = np.asarray(jax_noise.make_noiser("binom16", 1.0)(
        jax.random.key(1), jnp.zeros((4096,))))
    assert set(np.unique(jv * 2 + 8)) <= set(range(17))


@pytest.mark.parametrize("fused", [False, True])
def test_views_are_independent(fused):
    """Zero inputs: each view is its noise.  The 4 views (8 draws unfused)
    are pairwise uncorrelated: |r| < 0.02 over 80k elements each (sd of r
    is 3.5e-3)."""
    g = torch.Generator().manual_seed(2)
    z = torch.zeros
    views = two_net_views(make_noiser("normal", 1.0), fused, g,
                          z(200, 20, 20, 1), z(200, 400), z(200, 20, 20, 1),
                          z(200, 400))
    flat = torch.stack([v.reshape(-1) for v in views])
    assert flat.shape == (4, 160000)
    parts = [flat[:, :80000], flat[:, 80000:]]  # labeled, unlabeled draws
    rows = torch.cat(parts)                      # 8 draws
    r = torch.corrcoef(rows)
    off = r[~torch.eye(8, dtype=torch.bool)]
    assert off.abs().max() < 0.02


@pytest.mark.parametrize("impl,fused", itertools.product(
    ["normal", "binom16"], [False, True]))
def test_zero_noise_is_the_identity(rng, impl, fused):
    xp_l, xp_u = (torch.from_numpy(rng.normal(size=(b, 4, 4, 3))
                                   .astype(np.float32)) for b in (3, 5))
    x_l, x_u = (torch.from_numpy(rng.normal(size=(b, 7)).astype(np.float32))
                for b in (3, 5))
    g = torch.Generator().manual_seed(3)
    views = two_net_views(make_noiser(impl, 0.0), fused, g, xp_l, x_l, xp_u,
                          x_u)
    for v, want in zip(views, [torch.cat([xp_l, xp_u]), torch.cat([x_l, x_u])]
                       * 2):
        assert torch.equal(v, want)


# ----------------------------------------------------------------- model

def test_dropout_is_flax_dropout():
    g = torch.Generator().manual_seed(4)
    z = torch.full((200000,), 2.0)
    out = dropout(z, 0.8, g)
    kept = out != 0
    assert torch.equal(out[kept], torch.full_like(out[kept], 2.0 / 0.2))
    assert abs(float(kept.float().mean()) - 0.2) < 5e-3
    assert torch.equal(dropout(z, 0.8, torch.Generator().manual_seed(4)),
                       out)
    assert torch.equal(dropout(z, 1.0, g), torch.zeros_like(z))


def test_train_mode_draws_dropout_from_the_generator(rng):
    params = init_basenet2_params(0, n_pc=4, num_features=11,
                                  num_classes=5, patch_size=8)
    model = BaseNet2(num_features=11, dropout=0.5, num_classes=5, n_pc=4,
                     patch_size=8)
    model.load_state_dict(basenet2_state_dict_from_jax(params))
    xp = torch.from_numpy(rng.normal(size=(6, 8, 8, 4)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(6, 11)).astype(np.float32))
    a = model(xp, x, generator=torch.Generator().manual_seed(5))[0]
    b = model(xp, x, generator=torch.Generator().manual_seed(5))[0]
    c = model(xp, x, generator=torch.Generator().manual_seed(6))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()
    e1 = model(xp, x, generator=torch.Generator().manual_seed(5))[0]
    e2 = model(xp, x)[0]
    assert torch.equal(e1, e2)


def test_params_to_jax_inverts_the_transplant():
    params = init_basenet2_params(7, n_pc=16, num_features=103,
                                  num_classes=9)
    back = basenet2_params_to_jax(basenet2_state_dict_from_jax(params))
    assert back.keys() == params.keys()
    for name in params:
        for leaf in ("kernel", "bias"):
            a, b = back[name][leaf], params[name][leaf]
            assert a.shape == b.shape and a.dtype == b.dtype
            assert np.array_equal(a, b)


def test_config_defaults_equal():
    from cmlpl_tpu.train.state import CMLPLConfig as JaxConfig

    got = CMLPLConfig()
    want = JaxConfig()
    for f in ("num_classes", "num_features", "n_pc", "patch_size",
              "num_label", "labeled_batch", "unlabeled_batch", "val_batch",
              "lr", "num_epochs", "num_unlabel", "thr", "alpha",
              "queue_batch", "temperature", "dropout", "noise",
              "w_contrast", "w_consistency", "feat_dim", "seed",
              "compute_dtype", "input_dtype", "rng_impl", "noise_impl",
              "noise_fused", "gather_impl", "stack_nets", "extra_loss",
              "extra_weight", "memobank_size", "augment", "queue_size"):
        assert getattr(got, f) == getattr(want, f), f


# ------------------------------------------------------------ eval, report

def _runs(rng, cls):
    return [cls(oa=float(rng.random()), aa=float(rng.random()),
                kappa=float(rng.random()), producer=rng.random(9))
            for _ in range(3)]


@pytest.mark.parametrize("with_e", [False, True])
def test_report_csv_equal(tmp_path, with_e):
    runs_b = _runs(np.random.default_rng(1), Accuracy)
    runs_e = _runs(np.random.default_rng(2), Accuracy) if with_e else None
    save_report(str(tmp_path / "got.csv"), runs_b, runs_e)
    jax_save_report(str(tmp_path / "want.csv"),
                    [JaxAccuracy(*r) for r in runs_b],
                    [JaxAccuracy(*r) for r in runs_e] if with_e else None)
    assert (tmp_path / "got.csv").read_text() == \
        (tmp_path / "want.csv").read_text()


def test_metrics_csv_equal(tmp_path, rng):
    keys = ("loss_contrast", "total_loss", "acc")
    hist = [{k: np.float32(rng.normal()) for k in keys} for _ in range(5)]
    save_history(argparse.Namespace(metrics_csv=str(tmp_path / "got.csv")),
                 [{k: float(v) for k, v in m.items()} for m in hist])
    jax_save_history(
        argparse.Namespace(metrics_csv=str(tmp_path / "want.csv")), hist)
    assert (tmp_path / "got.csv").read_text() == \
        (tmp_path / "want.csv").read_text()


def test_validation_accuracy_equal(tiny, capsys):
    cube, gt, labels, splits = tiny
    params = init_basenet2_params(2, n_pc=16, num_features=103,
                                  num_classes=9)
    model = BaseNet2(num_features=103, num_classes=9, n_pc=16).eval()
    model.load_state_dict(basenet2_state_dict_from_jax(params))
    scene = prepare_scene(0, cube=cube, gt=gt, n_pc=16, device="cpu")
    got = validation_accuracy(lambda xp, x: model(xp, x)[0], scene,
                              splits.test, patch_size=20, num_classes=9,
                              tile=256, epoch=3)
    out = capsys.readouterr().out
    jmodel = JaxBaseNet2(num_features=103, num_classes=9, n_pc=16)
    want = jax_validation(
        lambda p, xp, x: jmodel.apply({"params": p}, xp, x)[0], params,
        jax_prepare_scene(0, cube=cube, gt=gt, n_pc=16), splits.test,
        patch_size=20, num_classes=9, tile=256, epoch=3)
    assert out == capsys.readouterr().out
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])
