"""Training steps on the ("data", "model") mesh (``core/mesh.
create_mesh_2d(tp=2)``) against the port's one-process step, noise and
dropout on: 2 gloo ranks (1 x 2) and 4 (2 x 2), CMLPL in f32, in bf16 and
with the memory bank, CPS, CCT, and the supervised trainer on BaseNet2,
BaseNet2Zoo, BaseNet1 (split over the model axis) and SSRN (a BatchNorm
model, replicated over it).

Every rank draws the one process's draws and the model ranks of a data
rank run its rows, so a step differs from the one-process step only in
the order of its sums: the classifier's partial products and the queue
similarities summed over the model ranks, the gradients over the data
ranks.  Step 1's metrics are held at ``LOSS_TOL``, its gradients and the
whole state after it (params, Adam moments, EMA teacher) at
``PARAM_TOL``, the queues and bank at ``QUEUE_TOL``, all three of
``tests/test_torch_port_dp_jax.py``; bf16 at
``tests/test_torch_port_bf16.py``'s bounds (losses 2e-3, a weight within
two Adam steps of lr, where a gradient within bf16's rounding of 0 may
take either sign).  Each rank holds 1/tp of every split tensor's width
(``feat_spe`` and ``classifier`` weights, their Adam moments and EMA,
the queue features), the model ranks of a data rank different blocks,
and after 3 steps the whole states of all ranks and the shards of equal
model index are bitwise equal.
"""

import numpy as np
import pytest
import torch

import torch_tp_worker as tw
from cmlpl_tpu_torch.core.mesh import tp_dim
from torch_port_threads import one_torch_thread  # noqa: F401

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)
QUEUE_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_LOSS_TOL = dict(rtol=2e-3, atol=2e-3)
#: bf16 gradients, of each tensor's largest: a bf16 product rounds to
#: 2**-8 (3.9e-3) of its size, and a gradient passes two such roundings
#: (the forward's and its own; measured: 7.4e-3)
BF16_GRAD_TOL = 1e-2
LR = 5e-4
LATER_TOL = dict(rtol=1e-4, atol=1e-5)
#: a gradient element below this share of the model's largest is rounding
#: (``tests/test_torch_port_dp_zoo.py``): SSRN's conv biases read only by
#: train-mode BatchNorms have the exact gradient 0, and the global
#: batch's statistics (two all-reduced passes) round otherwise than
#: ``torch.var_mean``; Adam then steps such a weight by up to lr either way
ROUNDING_ONLY = 1e-4

CASES = {"cmlpl": ("steps", dict(algo="cmlpl")),
         "cmlpl_bf16": ("steps", dict(algo="cmlpl",
                                      compute_dtype="bfloat16")),
         "cmlpl_memobank": ("steps", dict(algo="cmlpl",
                                          extra_loss="memobank")),
         "cps": ("steps", dict(algo="cps")),
         "cct": ("steps", dict(algo="cct")),
         "basenet2": ("zoo", dict(name="basenet2")),
         "basenet2_zoo": ("zoo", dict(name="basenet2_zoo")),
         "basenet1": ("zoo", dict(name="basenet1")),
         "ssrn": ("zoo", dict(name="ssrn"))}
WORLDS = {"1x2": 2, "2x2": 4}
REPLICATED = ("ssrn",)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case on each world (one world of each size), by world and
    case."""
    calls = [[task, dict(kw, tp=2)] for task, kw in CASES.values()]
    out = {}
    for name, world in WORLDS.items():
        ranks = tw.run_ranks("many", str(tmp_path_factory.mktemp(name)),
                             world=world, calls=calls)
        out[name] = {c: [r[k] for r in ranks] for k, c in enumerate(CASES)}
    return out


_ONE = {}


@pytest.fixture(scope="module", params=[(c, w) for c in CASES
                                        for w in WORLDS],
                ids=[f"{c}-{w}" for c in CASES for w in WORLDS])
def runs(request, worlds):
    case, world = request.param
    if case not in _ONE:
        task, kw = CASES[case]
        _ONE[case] = tw.TASKS[task](None, **kw)
    return dict(case=case, world=world, ranks=worlds[world][case],
                one=_ONE[case])


def _bf16(runs) -> bool:
    return runs["case"] == "cmlpl_bf16"


def test_first_step_metrics_match_one_process(runs):
    want = runs["one"]["metrics"][0]
    tol = BF16_LOSS_TOL if _bf16(runs) else LOSS_TOL
    for r in runs["ranks"]:
        got = r["metrics"][0]
        assert set(got) == set(want)
        for k in want:
            if _bf16(runs) and k == "acc":
                continue
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _rounding_only(runs) -> dict:
    """Per whole-gradient leaf (by its path in the params), the mask of
    the elements that are rounding only: below ROUNDING_ONLY of the
    model's largest gradient, on a model with BatchNorms."""
    grads = dict(tw.leaves(runs["one"]["grads"]))
    if runs["case"] not in REPLICATED:
        return {}
    top = max(float(np.abs(g).max()) for g in grads.values())
    return {k.split("/", 1)[1]: np.abs(g) < ROUNDING_ONLY * top
            for k, g in grads.items()}


def _close(k, got, want, tol, noisy=None, reach=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if noisy is not None and noisy.any():
        np.testing.assert_allclose(got[noisy], want[noisy], rtol=0,
                                   atol=reach, err_msg=k)
        got, want = got[~noisy], want[~noisy]
    np.testing.assert_allclose(got, want, err_msg=k, **tol)


def test_first_step_gradients_match_one_process(runs):
    """The whole gradients (split ones gathered): summed over the data
    ranks, and not over the model ranks, whose gradients are the one
    loss's; a backward that summed there would count them tp times.
    Each tensor at PARAM_TOL of its largest (bf16: within BF16_GRAD_TOL
    of it)."""
    want = dict(tw.leaves(runs["one"]["grads"]))
    noisy = _rounding_only(runs)
    top_model = max(float(np.abs(w).max()) for w in want.values())
    tol = dict(rtol=0, atol=BF16_GRAD_TOL) if _bf16(runs) else PARAM_TOL
    for r in runs["ranks"]:
        got = dict(tw.leaves(r["grads"]))
        assert set(got) == set(want)
        for k, w in want.items():
            top = float(np.abs(w).max())
            _close(k, got[k], w, dict(rtol=tol["rtol"],
                                      atol=tol["atol"] * top),
                   noisy.get(k.split("/", 1)[1]),
                   2 * ROUNDING_ONLY * top_model)


def test_state_after_one_step_matches_one_process(runs):
    """Params, Adam moments, the EMA teacher, queues and bank, gathered
    whole; a rounding-only weight within Adam's reach (2 lr); bf16:
    weights within two Adam steps, 99% of them within one."""
    want = dict(tw.leaves(runs["one"]["after1"]))
    noisy = _rounding_only(runs)
    for r in runs["ranks"]:
        got = dict(tw.leaves(r["after1"]))
        assert set(got) == set(want)
        for k, w in want.items():
            if _bf16(runs):
                if "/params/" in f"/{k}" or k.startswith("params/"):
                    np.testing.assert_allclose(got[k], w, rtol=0,
                                               atol=2 * LR, err_msg=k)
                    assert np.quantile(np.abs(got[k] - w), 0.99) <= LR, k
                continue
            tol = QUEUE_TOL if k.startswith(("queue", "bank")) else \
                PARAM_TOL
            mask = None
            if k.startswith(("params/", "ema/params/")):
                mask = noisy.get(k.split("params/", 1)[1])
            _close(k, got[k], w, tol, mask, 2 * LR)


def test_later_metrics_follow_the_one_process_run(runs):
    tol = BF16_LOSS_TOL if _bf16(runs) else LATER_TOL
    for step, want in enumerate(runs["one"]["metrics"]):
        for r in runs["ranks"]:
            for k in want:
                if _bf16(runs) and k == "acc":
                    continue
                np.testing.assert_allclose(r["metrics"][step][k], want[k],
                                           err_msg=f"step {step} {k}",
                                           **tol)


def test_each_rank_holds_its_blocks_of_the_split_tensors(runs):
    """Every leaf that the model axis splits (``tp_dim``) holds 1/2 of its
    width on each rank, that rank's block of the whole state; every other
    leaf is the whole one.  Replication in place of the split fails."""
    split = 0
    for rank, r in enumerate(runs["ranks"]):
        whole = dict(tw.leaves(r["final"]))
        local = dict(tw.leaves(r["local"]))
        assert set(local) == set(whole)
        for k, w in whole.items():
            dim = tp_dim(k, w.ndim)
            if dim is None or runs["case"] in REPLICATED:
                assert np.array_equal(local[k], w), k
                continue
            split += 1
            k_ = w.shape[dim] // 2
            assert local[k].shape[dim] == k_, k
            block = np.take(w, range((rank % 2) * k_, (rank % 2 + 1) * k_),
                            axis=dim)
            assert np.array_equal(local[k], block), k
    assert split if runs["case"] not in REPLICATED else not split


def test_model_ranks_hold_different_blocks(runs):
    """Ranks 0 and 1 are the model ranks of data rank 0: their
    ``feat_spe`` kernels are different blocks of one width; SSRN, with no
    ``feat_spe``, is the same on both."""
    a, b = (dict(tw.leaves(r["local"])) for r in runs["ranks"][:2])
    if runs["case"] in REPLICATED:
        assert all(np.array_equal(a[k], b[k]) for k in a)
        return
    kernels = [k for k in a if k.endswith("feat_spe/kernel")
               and "/mu/" not in k and "/nu/" not in k]
    assert kernels
    for k in kernels:
        assert a[k].shape == b[k].shape and not np.array_equal(a[k], b[k]), k


def test_feat_spe_is_placed_on_the_model_axis(runs):
    for r in runs["ranks"]:
        assert r["placed"] is (runs["case"] not in REPLICATED)
        if runs["case"].startswith("cmlpl"):
            assert r["tp_calls"] > 0


def test_replicas_are_bitwise_equal_after_3_steps(runs):
    """The whole states on every rank, the shards of one model index on
    every data rank, and the generators the one process's."""
    ranks = runs["ranks"]
    first = dict(tw.leaves(ranks[0]["final"]))
    for rank, r in enumerate(ranks):
        got = dict(tw.leaves(r["final"]))
        assert all(np.array_equal(got[k], v) for k, v in first.items())
        assert torch.equal(r["generator"], runs["one"]["generator"])
        twin = dict(tw.leaves(ranks[rank % 2]["local"]))
        local = dict(tw.leaves(r["local"]))
        assert all(np.array_equal(local[k], v) for k, v in twin.items())
    assert int(first["step"]) == 3
