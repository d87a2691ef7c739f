"""Four gloo ranks on the port's ("data", "model") mesh
(``create_mesh_2d(tp=2)``, 2 x 2) against the JAX package's trainers on
``create_mesh_2d(jax.devices()[:4], tp=2)``, on the CPU.

The protocol of ``tests/test_torch_port_dp_jax.py``: noise and dropout
off, both packages from the JAX trainer's initial state on the 2-D mesh
(carried across by ``*_state_from_jax``, each rank keeping its shards),
4 steps of CMLPL, CPS and CCT with the pool gather.  JAX's step is the
one-device program under GSPMD's tensor-parallel layout
(``basenet_tp_shardings``), the port's the same program with its own
collectives, so the metrics, the gathered params and queues and every
rank's shards (against JAX's shard on the same device) are held at that
file's ``LOSS_TOL``, ``PARAM_TOL`` and ``QUEUE_TOL``.
"""

import jax
import numpy as np
import pytest

import torch_tp_worker as tw
from cmlpl_tpu.core.mesh import create_mesh_2d as jax_create_mesh_2d
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
from torch_dist_worker import N_PC, TINY, TRAINERS, W
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
def mesh22():
    return jax_create_mesh_2d(jax.devices()[:4], tp=2)


@pytest.fixture(scope="module")
def batches(jax_scene):
    splits = jax_generate_splits(jax_scene.labels, num_label=5)
    return list(JaxSampler(splits, jax_scene.labels, 8, 16, num_unlabel=64,
                           seed=3).epoch())[:4]


@pytest.fixture(scope="module")
def jax_starts(mesh22):
    out = {}
    for algo, (jax_cls, _) in JAX.items():
        jt = jax_cls(JaxConfig(**NOISE_OFF, gather_impl="pool"),
                     mesh=mesh22, donate=False)
        out[algo] = (jt, jt.init_state(jax.random.key(0)))
    return out


@pytest.fixture(scope="module")
def four_ranks(jax_starts, batches, tmp_path_factory):
    """The three trainers' 4 steps on the same four ranks (one world),
    by trainer."""
    tmp = tmp_path_factory.mktemp("tp_from_tree")
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
            tp=2, algo=algo, tree_npz=str(tmp / f"{algo}.npz"),
            batches_npz=str(tmp / "batches.npz"), steps=4)])
    ranks = tw.run_ranks("many", str(tmp / "ranks"), world=4, calls=calls)
    return {a: [r[k] for r in ranks] for k, a in enumerate(jax_starts)}


@pytest.fixture(scope="module", params=list(JAX))
def parity(request, jax_scene, jax_starts, batches, four_ranks):
    algo = request.param
    jt, jstate = jax_starts[algo]
    jms = []
    for (epoch, bi), (li, ly, ui) in zip(STEPS, batches):
        kw = dict(epoch=epoch, batch_index=bi) if algo == "cmlpl" else {}
        jstate, jm = jt.train_step(jstate, jax_scene, li, ly, ui, **kw)
        jms.append({k: float(v) for k, v in jm.items()})
    return dict(algo=algo, ranks=four_ranks[algo], jms=jms, jstate=jstate)


def _jax_leaves(state):
    for path, leaf in jax.tree_util.tree_leaves_with_path(state):
        if not jax.dtypes.issubdtype(leaf.dtype, jax.dtypes.prng_key):
            yield tw.tree_path(path), leaf


def _tol(path):
    return QUEUE_TOL if path.startswith("queue") else PARAM_TOL


def test_four_rank_metrics_match_the_jax_2d_mesh_step(parity):
    for r in parity["ranks"]:
        for i, (jm, m) in enumerate(zip(parity["jms"], r["metrics"])):
            assert set(m) == set(jm)
            for k in jm:
                np.testing.assert_allclose(m[k], jm[k],
                                           err_msg=f"step {i} {k}",
                                           **LOSS_TOL)


def test_gathered_state_matches_the_jax_2d_mesh_state(parity):
    """Params, Adam moments and queues, gathered whole on every rank."""
    for r in parity["ranks"]:
        got = dict(tw.leaves(r["tree"]))
        seen = 0
        for path, leaf in _jax_leaves(parity["jstate"]):
            np.testing.assert_allclose(got[path], np.asarray(leaf),
                                       err_msg=path, **_tol(path))
            seen += 1
        assert seen == len(got)
        assert int(got["step"]) == 4


def test_each_rank_shard_matches_the_jax_device_shard(parity):
    devices = jax.devices()[:4]
    for r, res in enumerate(parity["ranks"]):
        local = dict(tw.leaves(res["local"]))
        for path, leaf in _jax_leaves(parity["jstate"]):
            shard, = [s for s in leaf.addressable_shards
                      if s.device == devices[r]]
            want = np.asarray(shard.data)
            assert local[path].shape == want.shape, path
            np.testing.assert_allclose(local[path], want, err_msg=path,
                                       **_tol(path))


def test_queues_match_the_jax_2d_mesh_queues(parity):
    """CMLPL's queues after 4 steps (CPS and CCT keep none)."""
    js = parity["jstate"]
    if parity["algo"] != "cmlpl":
        assert not any(k.startswith("queue")
                       for k in parity["ranks"][0]["tree"])
        return
    for r in parity["ranks"]:
        for name in ("queue_w", "queue_s"):
            want, got = getattr(js, name), r["tree"][name]
            assert int(got["ptr"]) == int(want.ptr) == (4 * 24) % 80
            assert r["local"][name]["feats"].shape == (80, 512)
            for k in ("feats", "probs"):
                np.testing.assert_allclose(got[k],
                                           np.asarray(getattr(want, k)),
                                           err_msg=f"{name}/{k}",
                                           **QUEUE_TOL)
