"""CMLPL's opt-in extras on the CPU (the trainer half of ROADMAP item 9):
the extra objectives, the robust CEs and the criterion factory, the memory
bank, the augmentations and ``stack_nets``, against the JAX package.

Objectives are held by value and gradient at f32 tolerance (rtol 1e-5,
atol 1e-6: sums in another order).  Random choices differ by design
(Philox is not threefry): the augmentations and the bank's choice are held
by their properties, and where a value must match JAX, both packages'
samplers are replaced by one deterministic rule, the first admissible
index.  Step parity follows ``tests/test_torch_port_train_step.py``
(noise and dropout off, 4 steps from the JAX trainer's state, losses rtol
1e-5), from a state whose net E is sharpened so that the bank has anchors;
its larger gradients put a few weights (2 of 37k in conv1) past that
file's atol 5e-5, so params are held to half an Adam step, lr / 2 =
2.5e-4: a weight whose gradient is within rounding of 0 can step up to lr
either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cmlpl_tpu.objectives.contrastive as jax_contrastive
from cmlpl_tpu.data import SemiSupervisedSampler as JaxSampler
from cmlpl_tpu.data import generate_splits as jax_generate_splits
from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.objectives import criterion as jax_criterion
from cmlpl_tpu.objectives import mmd as jax_mmd
from cmlpl_tpu.objectives import supervised as jax_supervised
from cmlpl_tpu.train import CMLPLConfig as JaxConfig
from cmlpl_tpu.train import CMLPLTrainer as JaxTrainer
from cmlpl_tpu_torch.cli import train as cli_train
from cmlpl_tpu_torch.core.rng import uniform
from cmlpl_tpu_torch.data import augment
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.objectives import contrastive, criterion, mmd, supervised
from cmlpl_tpu_torch.train.cmlpl import METRICS, CMLPLTrainer
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.utils.checkpoint import STATE_FILE, save_checkpoint
from torch_port_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
N_PC, W = 16, 20
TINY = dict(num_classes=9, num_features=103, n_pc=N_PC, patch_size=W,
            labeled_batch=8, unlabeled_batch=16, num_unlabel=64,
            num_epochs=2, noise=0.0, dropout=0.0, thr=0.13, queue_batch=1,
            gather_impl="pool")
STEPS = [(0, 0), (0, 2), (1, 0), (1, 1)]   # (epoch, batch index)


def _value_and_grads(jax_fn, torch_fn, args, diff):
    """fn(*args) and its gradients wrt the args at ``diff`` from both
    packages (a non-scalar output reduced against fixed weights)."""
    def reduce_(out, lib, w):
        return (out * w).sum() if lib is torch else jnp.sum(out * w)

    w = np.random.default_rng(9).normal(
        size=np.shape(jax_fn(*[jnp.asarray(a) for a in args]))
    ).astype(np.float32)
    jval, jgrads = jax.value_and_grad(
        lambda *a: reduce_(jax_fn(*a), jnp, w), argnums=diff)(
            *[jnp.asarray(a) for a in args])
    targs = [torch.tensor(a, requires_grad=i in diff)
             for i, a in enumerate(args)]
    tval = reduce_(torch_fn(*targs), torch, torch.from_numpy(w))
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=RTOL,
                               atol=ATOL)
    for i, jg in zip(diff, jgrads):
        np.testing.assert_allclose(targs[i].grad.numpy(), np.asarray(jg),
                                   rtol=1e-4, atol=ATOL)


def _labels(rng, n, c, ignored=0, ignore=-1):
    y = rng.integers(0, c, n).astype(np.int64)
    y[:ignored] = ignore
    return y


# ------------------------------------------------------------ objectives

def test_nt_xent_matches_jax(rng):
    a, b = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
    _value_and_grads(lambda x, y: jax_contrastive.nt_xent(x, y, 0.3),
                     lambda x, y: contrastive.nt_xent(x, y, 0.3), [a, b],
                     diff=(0, 1))


@pytest.mark.parametrize("kind", ["mmd", "mse", "kl", "cosine"])
def test_distribution_losses_match_jax(rng, kind):
    x = rng.normal(size=(7, 12)).astype(np.float32)
    y = (rng.normal(size=(7, 12)) + 0.5).astype(np.float32)
    _value_and_grads(lambda p, q: jax_mmd.distribution_loss(p, q, kind),
                     lambda p, q: mmd.distribution_loss(p, q, kind), [x, y],
                     diff=(0, 1))
    with pytest.raises(ValueError):
        mmd.distribution_loss(torch.zeros(2, 2), torch.zeros(2, 2), "l1")


def test_mmd_loss_of_unequal_sets_matches_jax(rng):
    x = rng.normal(size=(5, 8)).astype(np.float32)
    y = rng.normal(size=(11, 8)).astype(np.float32) * 2
    _value_and_grads(jax_mmd.mmd_loss, mmd.mmd_loss, [x, y], diff=(0, 1))


@pytest.mark.parametrize("ignored", [0, 4])
def test_reverse_cross_entropy_matches_jax(rng, ignored):
    logits = rng.normal(size=(12, 9)).astype(np.float32) * 2
    y = _labels(rng, 12, 9, ignored)
    _value_and_grads(
        lambda x, t: jax_supervised.reverse_cross_entropy(x, t, 9),
        lambda x, t: supervised.reverse_cross_entropy(x, t, 9),
        [logits, y], diff=(0,))


@pytest.mark.parametrize("percent,ignored", [(20, 0), (50, 3), (80, 0)])
def test_entropy_filtered_ce_matches_jax(rng, percent, ignored):
    logits = rng.normal(size=(16, 9)).astype(np.float32) * 2
    teacher = rng.normal(size=(16, 9)).astype(np.float32) * 3
    y = _labels(rng, 16, 9, ignored)
    _value_and_grads(
        lambda x, t, z: jax_supervised.entropy_filtered_ce(x, t, z, percent),
        lambda x, t, z: supervised.entropy_filtered_ce(x, t, z, percent),
        [logits, y, teacher], diff=(0,))


@pytest.mark.parametrize("thresh,min_kept,ignored", [
    (0.7, 4, 0), (0.2, 10, 2), (0.9, 64, 0)])
def test_ohem_cross_entropy_matches_jax(rng, thresh, min_kept, ignored):
    logits = rng.normal(size=(16, 9)).astype(np.float32) * 3
    y = _labels(rng, 16, 9, ignored)
    _value_and_grads(
        lambda x, t: jax_supervised.ohem_cross_entropy(x, t, thresh,
                                                       min_kept),
        lambda x, t: supervised.ohem_cross_entropy(x, t, thresh, min_kept),
        [logits, y], diff=(0,))


def test_weighted_cross_entropy_matches_jax(rng):
    logits = rng.normal(size=(12, 5)).astype(np.float32)
    y = _labels(rng, 12, 5, 2)
    wts = rng.random(5).astype(np.float32) + 0.5
    _value_and_grads(
        lambda x, t: jax_criterion.weighted_cross_entropy(x, t, wts),
        lambda x, t: criterion.weighted_cross_entropy(x, t, wts),
        [logits, y], diff=(0,))


@pytest.mark.parametrize("cfg", [
    {"criterion": {"type": "ce"}},
    {"criterion": {"type": "ohem", "kwargs": {"thresh": 0.5,
                                              "min_kept": 6}}},
    {"criterion": {"type": "ce", "kwargs": {
        "use_weight": True, "weights": [1.0, 2.0, 0.5, 1.5, 1.0]}},
     "dataset": {"ignore_label": 4}},
    {"criterion": {"type": "ce"}, "net": {"aux_loss": {"loss_weight": 0.4}}},
], ids=["ce", "ohem", "weighted", "aux"])
def test_get_criterion_matches_jax(rng, cfg):
    main = rng.normal(size=(10, 5)).astype(np.float32)
    aux = rng.normal(size=(10, 5)).astype(np.float32)
    ignore = cfg.get("dataset", {}).get("ignore_label", -1)
    y = _labels(rng, 10, 5, 2, ignore)
    got, want = criterion.get_criterion(cfg), jax_criterion.get_criterion(cfg)
    if "net" in cfg:
        _value_and_grads(lambda a, b, t: want((a, b), t),
                         lambda a, b, t: got((a, b), t), [main, aux, y],
                         diff=(0, 1))
    else:
        _value_and_grads(want, got, [main, y], diff=(0,))
    with pytest.raises(ValueError, match="weights"):
        criterion.get_criterion({"criterion": {"type": "ce", "kwargs": {
            "use_weight": True}}})


# ------------------------------------------------------------ memory bank

def _pin_first_choice(mp):
    """Both packages' bank samplers replaced by the first admissible
    index (0 where there is none, as either sampler gives)."""
    mp.setattr(jax_contrastive, "_masked_choice",
               lambda key, mask, n: jnp.broadcast_to(jnp.argmax(mask), (n,)))
    mp.setattr(jax.random, "randint",
               lambda key, shape, lo, hi, *a, **k: jnp.zeros(shape, jnp.int32))
    mp.setattr(contrastive, "choose",
               lambda u, mask: mask.long().argmax(-1, keepdim=True).expand(
                   *mask.shape[:-1], u.shape[-1]))


@pytest.fixture
def first_choice(monkeypatch):
    _pin_first_choice(monkeypatch)


def _bank_inputs(rng, n=24, c=5, d=8, size=6, filled=(2, 0, 1, 6, 0)):
    rep = rng.normal(size=(n, d)).astype(np.float32)
    teacher = rng.normal(size=(n, d)).astype(np.float32)
    z = rng.normal(size=(n, c)) * 3
    probs = (np.exp(z) / np.exp(z).sum(1, keepdims=True)).astype(np.float32)
    labels = probs.argmax(1).astype(np.int32)
    ent = -(probs * np.log(probs + 1e-10)).sum(1)
    low = ent <= np.median(ent)
    feats = np.zeros((c, size, d), np.float32)
    for k, m in enumerate(filled):
        feats[k, :m] = rng.normal(size=(m, d))
    bank = (feats, np.array(filled, np.int32),
            np.array(filled, np.int32) % size)
    return rep, teacher, probs, labels, low, ~low, bank


def test_memobank_contrastive_matches_jax(rng, first_choice):
    """The same bank and candidates: the loss, its gradient and the
    updated bank agree (rank window [1, 4) of 5 classes, so every class
    has candidates; one class is full and wraps)."""
    rep, teacher, probs, labels, low, high, (feats, count, ptr) = \
        _bank_inputs(rng)
    kw = dict(num_queries=4, num_negatives=3, temperature=0.5, low_rank=1,
              high_rank=4, max_push=3)
    jbank = jax_contrastive.MemoBankState(jnp.asarray(feats),
                                          jnp.asarray(count),
                                          jnp.asarray(ptr))

    def jfn(r):
        return jax_contrastive.memobank_contrastive(
            r, jnp.asarray(teacher), jnp.asarray(probs), jnp.asarray(labels),
            jnp.asarray(low), jnp.asarray(high), jbank, jax.random.key(0),
            **kw)

    (jloss, jnew), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(rep))
    trep = torch.from_numpy(rep).requires_grad_()
    bank = contrastive.MemoBankState(*(torch.from_numpy(a.copy())
                                       for a in (feats, count, ptr)))
    u = contrastive.memobank_draws(torch.Generator(), 5, "cpu",
                                   num_queries=4, num_negatives=3,
                                   max_push=3)
    loss, new = contrastive.memobank_contrastive(
        trep, torch.from_numpy(teacher), torch.from_numpy(probs),
        torch.from_numpy(labels), torch.from_numpy(low),
        torch.from_numpy(high), bank, u, temperature=0.5, low_rank=1,
        high_rank=4)
    loss.backward()
    assert float(jloss) > 0
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(trep.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=ATOL)
    for name in ("feats", "count", "ptr"):
        np.testing.assert_array_equal(getattr(new, name).numpy(),
                                      np.asarray(getattr(jnew, name)))
    assert not torch.equal(new.feats, bank.feats)   # the input is kept


def test_memobank_update_pushes_candidates_fifo():
    """Unpinned choice: each class writes min(candidates, max_push) rows
    drawn from its candidates at its pointer, wrapping, and keeps the
    rest; a class's draws are uniform over its candidates (5 standard
    errors over 4,000 pushes)."""
    c, size, d, n, max_push = 4, 5, 3, 10, 4
    feats = torch.arange(n, dtype=torch.float32)[:, None].repeat(1, d)
    mask = torch.zeros(c, n, dtype=torch.bool)
    mask[0, [1, 4, 7]] = True        # 3 candidates, fewer than max_push
    mask[1, :] = True                # 10 candidates: max_push rows
    mask[3, [2]] = True              # class 2 has none
    bank = contrastive.memobank_init(c, size, d)
    bank.ptr[:] = torch.tensor([0, 3, 4, 1], dtype=torch.int32)
    old = torch.randn(c, size, d, generator=torch.Generator().manual_seed(0))
    bank.feats.copy_(old)
    g = torch.Generator().manual_seed(1)
    new = contrastive.memobank_update(bank, feats, mask,
                                      uniform(g, (c, max_push), "cpu"))
    assert new.count.tolist() == [3, 4, 0, 1]
    assert new.ptr.tolist() == [3, 2, 4, 2]
    for k, rows in ((0, [0, 1, 2]), (1, [3, 4, 0, 1]), (3, [1])):
        got = new.feats[k, rows, 0].long().tolist()
        assert set(got) <= set(mask[k].nonzero()[:, 0].tolist())
        untouched = [r for r in range(size) if r not in rows]
        assert torch.equal(new.feats[k, untouched], old[k, untouched])
    assert torch.equal(new.feats[2], old[2])
    draws = torch.cat([contrastive.memobank_update(
        bank, feats, mask, uniform(g, (c, max_push), "cpu")).feats[0, :3, 0]
        for _ in range(1334)]).long()
    freq = torch.bincount(draws, minlength=n)[[1, 4, 7]].double() / len(draws)
    assert ((freq - 1 / 3).abs() < 5 * np.sqrt(2 / 9 / len(draws))).all()


# ------------------------------------------------------------ augmentations

def _images(n=4000, w=3, ch=2):
    """Patches whose images under the 8 flips and rotations all differ."""
    base = torch.arange(w * w * ch, dtype=torch.float32).reshape(1, w, w, ch)
    return base.repeat(n, 1, 1, 1)


def _which(out, candidates):
    """The index of each output among its candidate images."""
    hits = torch.stack([(out == c).flatten(1).all(1) for c in candidates])
    assert (hits.sum(0) == 1).all()
    return hits.float().argmax(0)


def _uniform(idx, k):
    """Frequencies of k outcomes within 5 standard errors of 1/k."""
    freq = torch.bincount(idx, minlength=k).double() / len(idx)
    se = np.sqrt((1 / k) * (1 - 1 / k) / len(idx))
    assert ((freq - 1 / k).abs() < 5 * se).all(), freq


def test_random_flip_picks_one_of_four_images_uniformly():
    xp = _images()
    out = augment.random_flip(torch.Generator().manual_seed(0), xp)
    x = xp[:1]
    imgs = [x, x.flip(2), x.flip(1), x.flip(1).flip(2)]
    _uniform(_which(out, imgs), 4)


def test_random_rot90_picks_one_of_four_rotations_uniformly():
    xp = _images()
    out = augment.random_rot90(torch.Generator().manual_seed(1), xp)
    x = xp[:1]
    want = [np.asarray(jnp.rot90(jnp.asarray(x.numpy()), k, axes=(1, 2)))
            for k in range(4)]
    _uniform(_which(out, [torch.from_numpy(a) for a in want]), 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_radiation_noise_scales_and_perturbs(dtype):
    """alpha * x + N(0, 1/25): on x = 1 each element's mean is its alpha,
    in [0.9, 1.1] and spread over it; a bf16 input comes back f32."""
    x = torch.ones(64, 20, 20, 16, dtype=dtype)
    out = augment.radiation_noise(torch.Generator().manual_seed(2), x)
    assert out.dtype == torch.float32
    alpha = out.mean(dim=(1, 2, 3))
    assert alpha.min() > 0.9 - 1e-2 and alpha.max() < 1.1 + 1e-2
    assert alpha.max() - alpha.min() > 0.15
    resid = out - alpha[:, None, None, None]
    assert abs(float(resid.std()) - 1 / 25) < 2e-3


def test_mixture_noise_mixes_within_a_class():
    """Each class a constant vector: a same-class partner leaves it, plus
    N(0, 1/25); a partner of another class would move it by ~1."""
    labels = torch.arange(256) % 4
    x = labels.float()[:, None, None, None].expand(256, 5, 5, 8).clone()
    out = augment.mixture_noise(torch.Generator().manual_seed(3), x, labels)
    resid = out - x
    assert resid.abs().max() < 0.3
    assert abs(float(resid.mean())) < 5e-3
    assert abs(float(resid.std()) - 1 / 25) < 2e-3


# ------------------------------------------------------------ the trainer

@pytest.fixture(scope="module")
def scenes():
    cube, gt = synthetic_scene(0)
    return (jax_prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC),
            prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC,
                          device="cpu"))


def _sharpen(jstate):
    """net E's classifier scaled 30 times, so that its probabilities are
    sharp from the first step and the bank's anchors exist."""
    params = dict(jstate.net_e.params)
    params["classifier"] = {k: v * 30 for k, v in params["classifier"].items()}
    return jstate._replace(net_e=jstate.net_e._replace(params=params))


@pytest.fixture(scope="module", params=["mmd", "ntxent", "memobank"])
def parity(request, scenes):
    """4 steps of both packages' CMLPL with ``extra_loss``, from the JAX
    trainer's state (net E sharpened); memobank with both samplers
    pinned."""
    extra = request.param
    jscene, scene = scenes
    mp = pytest.MonkeyPatch()
    if extra == "memobank":
        _pin_first_choice(mp)
    try:
        cfg = dict(TINY, extra_loss=extra, extra_weight=0.5)
        jt = JaxTrainer(JaxConfig(**cfg), donate=False)
        jstate = _sharpen(jax.device_get(jt.init_state(jax.random.key(0))))
        trainer = CMLPLTrainer(CMLPLConfig(**cfg), device="cpu")
        state = trainer.state_from_jax(jstate)
        splits = jax_generate_splits(jscene.labels, num_label=5)
        batches = JaxSampler(splits, jscene.labels, 8, 16, num_unlabel=64,
                             seed=3).epoch()
        jms, ms = [], []
        for (epoch, bi), (li, ly, ui) in zip(STEPS, batches):
            jstate, jm = jt.train_step(jstate, jscene, li, ly, ui,
                                       epoch=epoch, batch_index=bi)
            state, m = trainer.train_step(state, scene, li, ly, ui,
                                          epoch=epoch, batch_index=bi)
            jms.append({k: float(v) for k, v in jm.items()})
            ms.append({k: float(v) for k, v in m.items()})
    finally:
        mp.undo()
    return dict(extra=extra, jms=jms, ms=ms, trainer=trainer, state=state,
                jstate=jax.device_get(jstate))


def test_extra_loss_step_metrics_match_jax(parity):
    for i, (jm, m) in enumerate(zip(parity["jms"], parity["ms"])):
        assert set(m) == set(jm) == set(METRICS) | {"extra_loss"}
        for k in m:
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i} {k}")
    assert any(m["extra_loss"] > 0 for m in parity["ms"])


def test_extra_loss_state_matches_jax_after_4_steps(parity, tmp_path):
    """Params, and for memobank the bank, through the checkpoint's npz,
    whose keys are the JAX state's (``bank/...`` included)."""
    path = save_checkpoint(str(tmp_path), parity["trainer"], parity["state"])
    jstate = parity["jstate"]
    want = {"bank/feats": jstate.bank.feats, "bank/count": jstate.bank.count,
            "bank/ptr": jstate.bank.ptr} if parity["extra"] == "memobank" \
        else {}
    for net in ("net_b", "net_e"):
        for layer, leaves in getattr(jstate, net).params.items():
            for leaf, v in leaves.items():
                want[f"{net}/params/{layer}/{leaf}"] = v
    with np.load(f"{path}/{STATE_FILE}") as z:
        assert ("bank/feats" in z.files) == (parity["extra"] == "memobank")
        for k, v in want.items():
            np.testing.assert_allclose(z[k], np.asarray(v), rtol=1e-4,
                                       atol=2.5e-4, err_msg=k)
    if parity["extra"] == "memobank":
        assert int(jstate.bank.count.sum()) > 0


def test_stack_nets_equals_two_forwards(scenes):
    """Noise and dropout on: from one state, the stacked step draws the
    same views and masks and gives the same losses and gradients within
    f32 rounding (its convolutions batch the two nets)."""
    _, scene = scenes
    rng = np.random.default_rng(4)
    li = rng.choice(np.nonzero(scene.labels)[0], (1, 8))
    ui = rng.integers(0, scene.num_pixels, (1, 16))
    runs = []
    for stack in (False, True):
        trainer = CMLPLTrainer(CMLPLConfig(**dict(
            TINY, noise=0.5, dropout=0.5, stack_nets=stack)), device="cpu")
        state = trainer.init_state(9)
        state, m = trainer.train_epoch(state, scene, li,
                                       scene.labels[li] - 1, ui, epoch=1)
        grads = [p.grad.clone() for net in (state.net_b, state.net_e)
                 for p in net.model.parameters()]
        runs.append((m, grads, state.generator.get_state()))
    (m0, g0, s0), (m1, g1, s1) = runs
    for k in METRICS:
        np.testing.assert_allclose(m1[k].numpy(), m0[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for a, b in zip(g1, g0):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert torch.equal(s0, s1)


def test_cli_train_takes_the_extras(tmp_path, capsys):
    metrics = str(tmp_path / "m.csv")
    acc_b, _ = cli_train.main([
        "--dataID", "0", "--n_PC", str(N_PC), "--num_epochs", "1",
        "--labeled_batch_size", "16", "--unlabeled_batch_size", "16",
        "--num_unlabel", "160", "--val_batch_size", "256", "--device",
        "cpu", "--save_path_prefix", str(tmp_path), "--metrics_csv", metrics,
        "--extra_loss", "ntxent", "--extra_weight", "0.2", "--augment",
        "flip", "rot90", "radiation", "mixture", "--print_per_batches", "0"])
    header = open(metrics).read().splitlines()[0]
    assert header == "step," + ",".join(METRICS) + ",extra_loss"
    assert 0.0 <= acc_b.oa <= 1.0
    with pytest.raises(SystemExit):
        cli_train.main(["--extra_loss", "triplet", "--device", "cpu"])
    with pytest.raises(ValueError, match="augment"):
        CMLPLTrainer(CMLPLConfig(augment=("crop",)), device="cpu")
