"""Two gloo ranks of the port's trainers against the JAX package's on a
two-device mesh (``create_mesh(jax.devices()[:2])``), on the CPU.

Noise and dropout off (the protocol of
``tests/test_torch_port_train_step.py``), both packages from the JAX
trainer's initial state, carried across by ``*_state_from_jax`` and
placed on the ranks, 4 steps of CMLPL, CPS and CCT with the pool gather;
the metrics, params and queues are held at that file's ``LOSS_TOL``,
``PARAM_TOL`` and ``QUEUE_TOL``.  JAX's mesh step is the one-device
program (GSPMD), so this holds the port's data parallelism to the same
semantics: the global pseudo-label graph, the queue writes of the whole
batch in order, the global means and the summed gradient.
"""

import jax
import numpy as np
import pytest

from cmlpl_tpu.core.mesh import create_mesh as jax_create_mesh
from cmlpl_tpu.data import SemiSupervisedSampler as JaxSampler
from cmlpl_tpu.data import generate_splits as jax_generate_splits
from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.train import CCTTrainer as JaxCCTTrainer
from cmlpl_tpu.train import CMLPLConfig as JaxConfig
from cmlpl_tpu.train import CMLPLTrainer as JaxCMLPLTrainer
from cmlpl_tpu.train import CPSTrainer as JaxCPSTrainer
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.weights import (cct_state_from_jax,
                                     cmlpl_state_from_jax,
                                     cps_state_from_jax, save_params_npz)
from torch_dist_worker import N_PC, TINY, TRAINERS, W, run_ranks
from torch_port_threads import one_torch_thread  # noqa: F401

NOISE_OFF = dict(TINY, noise=0.0, dropout=0.0)
STEPS = [(0, 0), (0, 2), (1, 0), (1, 1)]   # (epoch, batch index)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)
QUEUE_TOL = dict(rtol=1e-5, atol=1e-5)
JAX = {"cmlpl": (JaxCMLPLTrainer, cmlpl_state_from_jax),
       "cps": (JaxCPSTrainer, cps_state_from_jax),
       "cct": (JaxCCTTrainer, cct_state_from_jax)}


@pytest.fixture(scope="module")
def jax_scene():
    cube, gt = synthetic_scene(0)
    return jax_prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC)


@pytest.fixture(scope="module")
def mesh2():
    return jax_create_mesh(jax.devices()[:2])


@pytest.fixture(scope="module")
def batches(jax_scene):
    splits = jax_generate_splits(jax_scene.labels, num_label=5)
    return list(JaxSampler(splits, jax_scene.labels, 8, 16, num_unlabel=64,
                           seed=3).epoch())[:4]


@pytest.fixture(scope="module")
def jax_starts(mesh2):
    """Each trainer's JAX trainer on the mesh and its initial state."""
    out = {}
    for algo, (jax_cls, _) in JAX.items():
        jt = jax_cls(JaxConfig(**NOISE_OFF, gather_impl="pool"), mesh=mesh2,
                     donate=False)
        out[algo] = (jt, jt.init_state(jax.random.key(0)))
    return out


@pytest.fixture(scope="module")
def two_ranks(jax_starts, batches, tmp_path_factory):
    """The three trainers' 4 steps on the same two ranks (one world), each
    from its JAX trainer's initial state, by trainer."""
    tmp = tmp_path_factory.mktemp("from_tree")
    np.savez(tmp / "batches.npz",
             **{k: np.stack([b[i] for b in batches])
                for i, k in enumerate(("li", "ly", "ui"))},
             epoch=np.array([e for e, _ in STEPS]),
             bi=np.array([b for _, b in STEPS]))
    calls = []
    for algo, (_, jstate) in jax_starts.items():
        port = TRAINERS[algo](CMLPLConfig(**NOISE_OFF), device="cpu")
        tree = port.state_to_jax(JAX[algo][1](jax.device_get(jstate), port))
        save_params_npz(str(tmp / f"{algo}.npz"), tree)
        calls.append(["from_tree", dict(
            algo=algo, tree_npz=str(tmp / f"{algo}.npz"),
            batches_npz=str(tmp / "batches.npz"), steps=4)])
    ranks = run_ranks("many", str(tmp / "ranks"), calls=calls)
    return {a: [r[k] for r in ranks] for k, a in enumerate(jax_starts)}


@pytest.fixture(scope="module", params=list(JAX))
def parity(request, jax_scene, jax_starts, batches, two_ranks):
    algo = request.param
    jt, jstate = jax_starts[algo]
    jms = []
    for (epoch, bi), (li, ly, ui) in zip(STEPS, batches):
        kw = dict(epoch=epoch, batch_index=bi) if algo == "cmlpl" else {}
        jstate, jm = jt.train_step(jstate, jax_scene, li, ly, ui, **kw)
        jms.append({k: float(v) for k, v in jm.items()})
    return dict(algo=algo, ranks=two_ranks[algo], jms=jms,
                jstate=jax.device_get(jstate))


def test_two_rank_metrics_match_the_jax_mesh_step(parity):
    for r in parity["ranks"]:
        for i, (jm, m) in enumerate(zip(parity["jms"], r["metrics"])):
            assert set(m) == set(jm)
            for k in jm:
                np.testing.assert_allclose(m[k], jm[k],
                                           err_msg=f"step {i} {k}",
                                           **LOSS_TOL)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def test_two_rank_params_match_the_jax_mesh_params(parity):
    js = parity["jstate"]
    for r in parity["ranks"]:
        tree = r["tree"]
        nets = ((None,) if parity["algo"] == "cct"
                else ("net_b", "net_e"))
        for net in nets:
            got = tree[net]["params"] if net else tree["params"]
            want = getattr(js, net).params if net else js.params
            want = dict(jax.tree_util.tree_leaves_with_path(want))
            pairs = dict(_leaves(got))
            assert len(pairs) == len(want)
            for path, w_ in want.items():
                key = "".join(f"/{getattr(p, 'key', p)}" for p in path)
                np.testing.assert_allclose(pairs[key], np.asarray(w_),
                                           err_msg=f"{net}{key}",
                                           **PARAM_TOL)
        assert int(tree["step"]) == int(js.step) == 4


def test_two_rank_queues_match_the_jax_mesh_queues(parity):
    """CMLPL's queues (CPS and CCT keep none: their states hold no other
    tensor than params, Adams and step)."""
    js = parity["jstate"]
    if parity["algo"] != "cmlpl":
        assert set(parity["ranks"][0]["tree"]) == (
            {"net_b", "net_e", "step"} if parity["algo"] == "cps" else
            {"params", "opt_base", "opt_aug", "step"})
        return
    for r in parity["ranks"]:
        for name in ("queue_w", "queue_s"):
            want, got = getattr(js, name), r["tree"][name]
            assert int(got["ptr"]) == int(want.ptr) == (4 * 24) % 80
            for k in ("feats", "probs"):
                np.testing.assert_allclose(got[k],
                                           np.asarray(getattr(want, k)),
                                           err_msg=f"{name}/{k}",
                                           **QUEUE_TOL)
