"""The port's comparison-model zoo vs the JAX package's, model by model, on
the CPU: ``cmlpl_tpu_torch/models/{zoo,basenet,attention,ssftt,dbda,ssrn,
fdssc,msvit,common}.py`` and the zoo's weight transplant and init in
``cmlpl_tpu_torch/weights.py``.

Each of the nine ``ZOO`` entries is built at a small size (16 bands, 4
classes, w 5-8, B 6) in both packages; the port's model takes the JAX
model's variables (``zoo_state_dict_from_jax``), with the BN running
statistics randomised so that eval mode reads them.  Dropout is active in
training mode in SSFTT and FDSSC: a flax interceptor draws each mask with
numpy and records it, and the port's ``keep_mask`` replays the same masks
in the same order.

Tolerances: forward outputs rtol 1e-5 / atol 1e-5 (XLA:CPU and PyTorch sum
the convolutions and matmuls in other orders: the measured worst is 2.4e-6,
SSRN in train mode); batch statistics after one train-mode forward atol
5e-5, the bound of ``tests/test_torch_port_train_step.py`` for params
(flax takes the variance as E[x^2] - E[x]^2, the port as torch.var_mean).
"""

import types
import zlib
from collections import namedtuple

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmlpl_tpu.models import zoo as jax_zoo
from cmlpl_tpu.models.msvit import mish as jax_mish
from cmlpl_tpu_torch.models import common, zoo
from cmlpl_tpu_torch.models.msvit import mish
from cmlpl_tpu_torch.weights import (init_zoo_params,
                                     zoo_state_dict_from_jax,
                                     zoo_variables_to_jax)
from torch_port_threads import one_torch_thread  # noqa: F401

Spec = namedtuple("Spec", "num_bands num_classes")
SPEC = Spec(16, 4)
# (w, n_pc) per entry: MSViT's image size is 8; SSRN's (5,5,1) pool needs
# w >= 7; SSFTT two valid 3x3 convs
SHAPES = {"basenet1": (8, 5), "basenet2": (8, 6), "basenet2_zoo": (8, 6),
          "ssftt": (7, 5), "dbda": (5, 16), "dbda_feature": (5, 16),
          "ssrn": (7, 16), "fdssc": (5, 16), "msvit": (8, 6)}
B = 6
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
STATS_TOL = dict(rtol=1e-5, atol=5e-5)


def recording_dropout(rng: np.random.Generator, masks: list):
    """A flax interceptor: every active ``nn.Dropout`` draws its keep mask
    from ``rng`` (keep with probability 1 - rate, as flax) and appends it
    to ``masks``."""
    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if not (isinstance(mod, fnn.Dropout)
                and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        det = kwargs.get("deterministic")
        det = mod.deterministic if det is None else det
        if det or mod.rate == 0:
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = rng.random(x.shape) < 1.0 - mod.rate
        masks.append(keep)
        return jnp.where(keep, x / (1.0 - mod.rate), 0.0)

    return interceptor


def replay_masks(monkeypatch, masks: list) -> list:
    """The port's ``keep_mask`` takes ``masks`` in order; returns the list,
    empty once every mask was taken."""
    pending = list(masks)

    def keep_mask(shape, rate, generator, device):
        keep = pending.pop(0)
        assert keep.shape == tuple(shape)
        return torch.from_numpy(keep)

    monkeypatch.setattr(common, "keep_mask", keep_mask)
    return pending


def _inputs(entry, rng, w, n_pc):
    xp = rng.normal(size=(B, w, w, n_pc)).astype(np.float32)
    x = rng.normal(size=(B, SPEC.num_bands)).astype(np.float32)
    return (xp, x) if entry.inputs == "dual" else (xp,)


@pytest.fixture(scope="module", params=sorted(SHAPES))
def pair(request):
    """One entry in both packages: the JAX model and its variables (BN
    statistics randomised), the port's model holding them, the inputs."""
    name = request.param
    w, n_pc = SHAPES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    jm, entry = jax_zoo.build_model(name, SPEC, n_pc)
    args = _inputs(entry, rng, w, n_pc)
    v = dict(jax.device_get(jm.init(jax.random.key(3), *args, train=False)))
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map(
            lambda a: (rng.normal(size=a.shape) * 0.1 if a.mean() == 0
                       else rng.uniform(0.5, 1.5, a.shape)).astype(
                np.float32), v["batch_stats"])
    model, tentry = zoo.build_model(name, SPEC, n_pc, w)
    model.load_state_dict(zoo_state_dict_from_jax(name, v))
    return types.SimpleNamespace(name=name, w=w, n_pc=n_pc, jm=jm,
                                 entry=entry, tentry=tentry, v=v,
                                 model=model, args=args)


def _outputs(out, entry):
    """[logits, feature] of a model's output, or [logits] when the entry
    returns logits only."""
    if entry.returns_feature:
        return [np.asarray(o) for o in out]
    return [np.asarray(out)]


def test_entries_match_jax():
    assert sorted(zoo.ZOO) == sorted(jax_zoo.ZOO)
    for name, e in zoo.ZOO.items():
        j = jax_zoo.ZOO[name]
        assert (e.inputs, e.returns_feature, e.default_patch,
                e.default_n_pc) == (j.inputs, j.returns_feature,
                                    j.default_patch, j.default_n_pc)


def test_eval_forward_matches_jax(pair):
    want = pair.jm.apply(pair.v, *pair.args, train=False)
    pair.model.eval()
    with torch.no_grad():
        got = pair.model(*map(torch.from_numpy, pair.args))
    for g, wnt in zip(_outputs(got, pair.entry), _outputs(want, pair.entry)):
        np.testing.assert_allclose(g, wnt, **FWD_TOL)


def test_train_forward_and_batch_stats_match_jax(pair, monkeypatch):
    """One train-mode forward: the outputs (same dropout masks) and the
    updated BN running statistics."""
    masks = []
    mutable = ["batch_stats"] if "batch_stats" in pair.v else False
    with fnn.intercept_methods(recording_dropout(
            np.random.default_rng(5), masks)):
        res = pair.jm.apply(pair.v, *pair.args, train=True,
                            mutable=mutable, rngs={"dropout":
                                                   jax.random.key(0)})
    want, updates = res if mutable else (res, {})
    assert bool(masks) == (pair.name in ("ssftt", "fdssc"))
    pending = replay_masks(monkeypatch, masks)
    model = pair.model
    model.load_state_dict(zoo_state_dict_from_jax(pair.name, pair.v))
    model.train()
    with torch.no_grad():
        got = model(*map(torch.from_numpy, pair.args))
    assert not pending
    for g, wnt in zip(_outputs(got, pair.entry), _outputs(want, pair.entry)):
        np.testing.assert_allclose(g, wnt, **FWD_TOL)
    stats = zoo_variables_to_jax(pair.name, model.state_dict())["batch_stats"]
    want_stats = updates.get("batch_stats", {})
    assert (jax.tree_util.tree_structure(stats)
            == jax.tree_util.tree_structure(jax.device_get(want_stats)))
    for g, wnt in zip(jax.tree_util.tree_leaves(stats),
                      jax.tree_util.tree_leaves(want_stats)):
        np.testing.assert_allclose(g, np.asarray(wnt), **STATS_TOL)
    if mutable:   # the statistics moved
        assert any(not np.allclose(g, b) for g, b in zip(
            jax.tree_util.tree_leaves(stats),
            jax.tree_util.tree_leaves(pair.v["batch_stats"])))


def test_param_count_matches_jax(pair):
    want = sum(a.size for a in jax.tree_util.tree_leaves(pair.v["params"]))
    assert sum(p.numel() for p in pair.model.parameters()) == want


def test_transplant_round_trip(pair):
    back = zoo_variables_to_jax(pair.name, zoo_state_dict_from_jax(
        pair.name, pair.v))
    want = {"params": pair.v["params"],
            "batch_stats": pair.v.get("batch_stats", {})}
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(want))
    for g, wnt in zip(jax.tree_util.tree_leaves(back),
                      jax.tree_util.tree_leaves(want)):
        assert g.dtype == np.float32 and g.shape == np.shape(wnt)
        np.testing.assert_array_equal(g, np.asarray(wnt))


def test_init_draws_flax_distributions(pair):
    """``init_zoo_params`` has the JAX init's tree and shapes; constant
    leaves (zeros, ones, PReLU's 0.01) equal it; random leaves of 256+
    entries have its standard deviation within 15% and a mean within a
    quarter of it."""
    got = init_zoo_params(pair.name, 7, spec=SPEC, n_pc=pair.n_pc,
                          patch_size=pair.w)
    jv = pair.jm.init(jax.random.key(11), *pair.args, train=False)
    want = {"params": jv["params"], "batch_stats": jv.get("batch_stats", {})}
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for (path, g), wnt in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                              jax.tree_util.tree_leaves(want)):
        wnt = np.asarray(wnt)
        assert g.shape == wnt.shape and g.dtype == np.float32, path
        if wnt.size == 0 or np.all(wnt == wnt.flat[0]):
            np.testing.assert_array_equal(g, wnt, err_msg=str(path))
        elif wnt.size >= 256:
            assert abs(g.std() / wnt.std() - 1) < 0.15, path
            assert abs(g.mean()) < 0.25 * wnt.std(), path


def test_build_model_resolves_all_bands():
    model, entry = zoo.build_model("dbda", SPEC, -1, 5)
    assert entry.default_n_pc == -1
    assert model.trunk.conv21.kernel_size == (1, 1, SPEC.num_bands)


def test_weight_ema_matches_jax():
    rng = np.random.default_rng(0)
    base = {"a": rng.normal(size=(3, 4)), "b": rng.normal(size=(5,))}
    ema = {k: rng.normal(size=v.shape) for k, v in base.items()}
    base, ema = ({k: v.astype(np.float32) for k, v in t.items()}
                 for t in (base, ema))
    want = jax_zoo.weight_ema(base, ema, 0.95)
    got = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    zoo.weight_ema({k: torch.from_numpy(v) for k, v in base.items()}, got,
                   0.95)
    for k in base:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_mish_matches_jax():
    x = np.linspace(-30, 30, 601, dtype=np.float32)
    np.testing.assert_allclose(mish(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_mish(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def test_style_randomisations_match_jax():
    """spa/spe_randomization with the permutation JAX drew."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(6, 5, 5, 8)) * 2 + 1).astype(np.float32)
    want, idx = jax_zoo.spa_randomization(jnp.asarray(x), jax.random.key(4))
    perm = torch.from_numpy(np.asarray(idx).astype(np.int64))
    assert sorted(perm.tolist()) == list(range(6))
    got = zoo.spa_randomization(torch.from_numpy(x), perm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    f = (rng.normal(size=(6, 32)) * 3 - 1).astype(np.float32)
    want = jax_zoo.spe_randomization(jnp.asarray(f), idx)
    got = zoo.spe_randomization(torch.from_numpy(f), perm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("momentum,eps", [(0.99, 1e-5), (0.9, 1e-3)])
def test_batchnorm_has_flax_running_statistics(momentum, eps):
    """Two train-mode calls then one in eval mode on 5-D input (channels
    on dim 1 in the port, last in flax): outputs and the running mean and
    biased variance, blended by flax's momentum."""
    rng = np.random.default_rng(2)
    xs = [(rng.normal(size=(4, 3, 5, 6, 7)) * 2 + 0.5).astype(np.float32)
          for _ in range(3)]
    bn = fnn.BatchNorm(momentum=momentum, epsilon=eps)
    last = [np.moveaxis(x, 1, -1) for x in xs]
    v = bn.init(jax.random.key(0), last[0], use_running_average=False)
    ours = common.BatchNorm(3, momentum=momentum, eps=eps)
    for x, xl in zip(xs[:2], last[:2]):
        want, upd = bn.apply(v, xl, use_running_average=False,
                             mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
        got = ours(torch.from_numpy(x))
        np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.running_mean.numpy(),
                               np.asarray(v["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours.running_var.numpy(),
                               np.asarray(v["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    ours.eval()
    want = bn.apply(v, last[2], use_running_average=True)
    got = ours(torch.from_numpy(xs[2]))
    np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_prelu_matches_flax():
    x = np.linspace(-3, 3, 13, dtype=np.float32)
    pr = fnn.PReLU()
    v = pr.init(jax.random.key(0), x)
    assert float(v["params"]["negative_slope"]) == pytest.approx(0.01)
    v = {"params": {"negative_slope": jnp.float32(0.3)}}
    ours = common.PReLU()
    with torch.no_grad():
        ours.negative_slope.fill_(0.3)
    np.testing.assert_array_equal(ours(torch.from_numpy(x)).detach().numpy(),
                                  np.asarray(pr.apply(v, x)))
