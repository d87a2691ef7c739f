"""The ("data", "model") mesh's layout (``core/mesh.create_mesh_2d``,
``tp_dim``, ``tp_shard_tree``) against the JAX package's
``create_mesh_2d`` and ``basenet_tp_shardings`` on the CPU.

Four gloo ranks: rank r is (r // tp, r % tp), JAX's
``devices.reshape(n // tp, tp)``; the refusals.  For the states of CMLPL,
CPS, CCT and the supervised trainer on BaseNet1, BaseNet2 and
BaseNet2Zoo (with an EMA teacher), each carried from the JAX trainer's
initial state on ``create_mesh_2d(jax.devices()[:4], tp=2)``, the port's
shard of every leaf on rank (d, m), Adam's moments, the EMA and the
queue features included, is bitwise JAX's ``addressable_shards`` data
on device (d, m), and the shards gather back into the whole tree.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_tp_worker as tw
from cmlpl_tpu.core.mesh import create_mesh_2d as jax_create_mesh_2d
from cmlpl_tpu.models.zoo import build_model as jax_build_model
from cmlpl_tpu.registry import get_dataset as jax_get_dataset
from cmlpl_tpu.train import CCTTrainer as JaxCCTTrainer
from cmlpl_tpu.train import CMLPLConfig as JaxConfig
from cmlpl_tpu.train import CMLPLTrainer as JaxCMLPLTrainer
from cmlpl_tpu.train import CPSTrainer as JaxCPSTrainer
from cmlpl_tpu.train.supervised import SupervisedTrainer as JaxSupervised
from cmlpl_tpu_torch.core.mesh import Mesh, create_mesh_2d, tp_dim
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.weights import (cct_state_from_jax, cmlpl_state_from_jax,
                                     cps_state_from_jax, save_params_npz,
                                     supervised_state_from_jax)
from torch_dist_worker import (TINY, TRAINERS, ZOO_BANDS, ZOO_CLASSES,
                               ZOO_SHAPES, zoo_setup)
from torch_port_threads import one_torch_thread  # noqa: F401

NOISE_OFF = dict(TINY, noise=0.0, dropout=0.0)
JAX = {"cmlpl": (JaxCMLPLTrainer, cmlpl_state_from_jax),
       "cps": (JaxCPSTrainer, cps_state_from_jax),
       "cct": (JaxCCTTrainer, cct_state_from_jax)}
ZOO = ("basenet1", "basenet2", "basenet2_zoo")
KINDS = tuple(JAX) + ZOO


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_create_mesh_2d(jax.devices()[:4], tp=2)


def _jax_trainer(kind, mesh):
    if kind in JAX:
        return JAX[kind][0](JaxConfig(**NOISE_OFF, gather_impl="pool"),
                            mesh=mesh, donate=False)
    w, n_pc = ZOO_SHAPES[kind]
    jspec = dataclasses.replace(jax_get_dataset(0), num_classes=ZOO_CLASSES,
                                num_bands=ZOO_BANDS)
    model, entry = jax_build_model(kind, jspec, n_pc)
    return JaxSupervised(model, entry, patch_size=w, n_pc=n_pc,
                         num_features=ZOO_BANDS, donate=False,
                         gather_impl="xla", mesh=mesh, ema_alpha=0.9)


@pytest.fixture(scope="module")
def jax_states(jax_mesh, tmp_path_factory):
    """Per kind: the JAX trainer's initial state on the 2 x 2 mesh, and
    the npz of its whole tree as the port carries it."""
    tmp = tmp_path_factory.mktemp("tp_layout")
    out = {}
    for kind in KINDS:
        jt = _jax_trainer(kind, jax_mesh)
        jstate = jt.init_state(jax.random.key(0))
        host = jax.device_get(jstate)
        if kind in JAX:
            port = TRAINERS[kind](CMLPLConfig(**NOISE_OFF), device="cpu")
            tree = port.state_to_jax(JAX[kind][1](host, port))
        else:
            port = zoo_setup(kind, None, ema_alpha=0.9)[0]
            tree = port.state_to_jax(supervised_state_from_jax(host, port))
        path = str(tmp / f"{kind}.npz")
        save_params_npz(path, tree)
        out[kind] = dict(jt=jt, jstate=jstate, npz=path)
    return out


@pytest.fixture(scope="module")
def ranks(jax_states, tmp_path_factory):
    calls = [["coords", {}],
             ["layout", dict(tp=2, trees=[(k, s["npz"])
                                          for k, s in jax_states.items()])],
             ["grads", dict(tp=2)]]
    return tw.run_ranks("many", str(tmp_path_factory.mktemp("tp_mesh")),
                        world=4, calls=calls)


def _jax_leaves(state):
    """(path, leaf) of a JAX state, its PRNG key left out."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(state):
        if jax.dtypes.issubdtype(leaf.dtype, jax.dtypes.prng_key):
            continue
        yield tw.tree_path(path), leaf


@pytest.mark.parametrize("tp", [2, 4])
def test_ranks_take_jax_reshape_coordinates(ranks, tp):
    """Rank r at (r // tp, r % tp); rows over the data axis, a 1,024
    width's columns over the model axis."""
    for r, res in enumerate(ranks):
        d, m, data_size, t, rows, cols = res[0][tp]
        assert (d, m, data_size, t) == (r // tp, r % tp, 4 // tp, tp)
        k = 8 // data_size
        assert rows == (d * k, (d + 1) * k)
        assert cols == (m * 1024 // tp, (m + 1) * 1024 // tp)


def test_jax_mesh_places_devices_as_the_ranks(jax_mesh):
    devices = jax.devices()[:4]
    for r in range(4):
        assert jax_mesh.devices[r // 2, r % 2] == devices[r]
    assert jax_mesh.axis_names == ("data", "model")


@pytest.mark.parametrize("tp", [0, 3, 8])
def test_a_tp_that_does_not_divide_is_refused(ranks, tp):
    for res in ranks:
        msg = res[0][f"refused{tp}"]
        assert f"tp={tp}" in msg and "(1024, 2624, 256)" in msg


def test_tp_1_is_the_data_mesh(ranks):
    for res in ranks:
        assert res[0]["tp1"] == (1, 4, None, None)


def test_one_process_refuses_a_model_axis():
    with pytest.raises(ValueError, match="must divide the 1 ranks"):
        create_mesh_2d(2, "cpu")
    mesh = create_mesh_2d(1, "cpu")
    assert (mesh.rank, mesh.size, mesh.tp, mesh.backend) == (0, 1, 1, None)


def test_mesh_rows_and_columns_follow_their_axes():
    for rank in range(8):
        mesh = Mesh(rank, 8, torch.device("cpu"), "gloo", tp=4)
        assert (mesh.data, mesh.model, mesh.data_size) == (rank // 4,
                                                           rank % 4, 2)
        assert mesh.rows(6) == ((rank // 4) * 3, (rank // 4 + 1) * 3)
        assert mesh.cols(2624) == ((rank % 4) * 656, (rank % 4 + 1) * 656)
        with pytest.raises(ValueError, match="do not divide"):
            mesh.cols(10)


def test_gradients_sum_over_the_data_axis_alone(ranks):
    """Every gradient holds rank + 1 before ``all_reduce_grads``: a split
    one's is then its data ranks' sum (model rank 0: 1 + 3, model rank 1:
    2 + 4), a replicated one's model rank 0's sum on every rank (model
    ranks round a card's convolution backward apart)."""
    split = ("feat_spe.weight", "feat_spe.bias", "classifier.weight")
    for r, res in enumerate(ranks):
        grads = res[2]
        assert any(n.endswith(split) for n in grads)
        for name, values in grads.items():
            want = (4.0 + 2.0 * (r % 2)) if name.endswith(split) else 4.0
            assert values == [want], (r, name, values)


@pytest.mark.parametrize("kind", KINDS)
def test_tp_dim_is_basenet_tp_shardings(kind, jax_states):
    """The split dim of every leaf, by its path, is the dim JAX's state
    sharding puts on "model" (none: replicated)."""
    split = 0
    for path, leaf in _jax_leaves(jax_states[kind]["jstate"]):
        spec = tuple(leaf.sharding.spec)
        want = [i for i, ax in enumerate(spec) if ax == "model"]
        got = tp_dim(path, leaf.ndim)
        assert ([] if got is None else [got]) == want, path
        split += bool(want)
    assert split >= 3


@pytest.mark.parametrize("kind", KINDS)
def test_each_rank_holds_the_jax_device_shard(kind, jax_states, ranks):
    """Every leaf of rank r's state (the params, Adam's moments, the EMA
    and the queues) is bitwise the data of JAX's shard on device r."""
    devices = jax.devices()[:4]
    for r, res in enumerate(ranks):
        local = dict(tw.leaves(res[1][kind]["local"]))
        seen = set()
        for path, leaf in _jax_leaves(jax_states[kind]["jstate"]):
            shard, = [s for s in leaf.addressable_shards
                      if s.device == devices[r]]
            want = np.asarray(shard.data)
            assert local[path].shape == want.shape, path
            assert np.array_equal(local[path], want), path
            seen.add(path)
        assert seen == set(local)


@pytest.mark.parametrize("kind", KINDS)
def test_feat_spe_is_placed_on_every_rank(kind, ranks):
    for res in ranks:
        assert res[1][kind]["placed"]


@pytest.mark.parametrize("kind", KINDS)
def test_shards_gather_back_into_the_whole_tree(kind, ranks, jax_states):
    with np.load(jax_states[kind]["npz"]) as z:
        whole = {k: z[k] for k in z.files}
    for res in ranks:
        got = dict(tw.leaves(res[1][kind]["whole"]))
        assert set(got) == set(whole)
        for k, v in whole.items():
            assert np.array_equal(got[k], v), k
