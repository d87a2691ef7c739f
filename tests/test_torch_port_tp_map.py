"""The scene maps, fused seeds and checkpoints on the ("data", "model")
mesh (``create_mesh_2d(tp=2)``, four gloo ranks: 2 x 2), on the CPU.

- Maps: after two CMLPL steps on the mesh, net B's whole weights
  (gathered by ``state_to_jax``) map the scene on the mesh; the tiles
  and the dense map's strips of scene rows go over the two data ranks,
  and each model rank maps its data rank's share (the JAX package's
  ``shard_map`` over ``axis_names[0]``).  Both maps are bitwise the
  one-process maps of those weights.
- Fused seeds (``train_multi_run``, 4 seeds): over the data ranks, each
  with whole states, as the JAX package composes no model axis with the
  seed axis; the one-process fused run's at
  ``tests/test_torch_port_dp_fused.py``'s ``METRIC_TOL``.
- Checkpoints: every rank calls ``save_checkpoint``; rank 0 writes the
  whole tree, within ``PARAM_TOL`` of the one-process run's
  ``state.npz`` after the same steps, and ``restore_checkpoint`` builds
  each rank's shards of it bitwise.
"""

import numpy as np
import pytest
import torch

import torch_tp_worker as tw
from cmlpl_tpu_torch.cli._common import logits_fn
from cmlpl_tpu_torch.eval.inference import ScenePredictor
from cmlpl_tpu_torch.models.basenet import BaseNet2
from cmlpl_tpu_torch.utils.checkpoint import STATE_FILE
from cmlpl_tpu_torch.weights import load_params_npz, state_dict_from_jax
from torch_dist_worker import N_PC, W, tiny_scene
from torch_port_threads import one_torch_thread  # noqa: F401

METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)
QUEUE_TOL = dict(rtol=1e-5, atol=1e-5)
TILE = 256
FUSED = ("cmlpl", "cct")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("tp_ckpt")
    calls = ([["map", dict(tp=2, tile=TILE)]]
             + [["fused", dict(tp=2, algo=a)] for a in FUSED]
             + [["checkpoint", dict(tp=2, directory=str(ckpt))]])
    return tw.run_ranks("many", str(tmp_path_factory.mktemp("tp_map")),
                        world=4, calls=calls)


@pytest.fixture(scope="module")
def one_maps(ranks):
    """The one-process tiled and dense maps of rank 0's whole weights."""
    scene, _ = tiny_scene()
    model = BaseNet2(num_features=103, num_classes=9, n_pc=N_PC,
                     patch_size=W).eval()
    model.load_state_dict(state_dict_from_jax(ranks[0][0]["params"]))
    tiled = ScenePredictor(logits_fn(model), patch_size=W, cols=scene.cols,
                           tile=TILE, gather="xla")(scene)
    dense = ScenePredictor(None, patch_size=W, cols=scene.cols,
                           gather="dense", params=model.state_dict())(scene)
    return {"tiled": tiled, "dense": dense, "pixels": scene.num_pixels}


def test_every_rank_maps_with_the_same_whole_weights(ranks):
    want = ranks[0][0]["params"]
    assert want["feat_spe"]["kernel"].shape == (103, 1024)
    for res in ranks:
        got = res[0]["params"]
        for layer in want:
            for k in want[layer]:
                assert np.array_equal(got[layer][k], want[layer][k])


@pytest.mark.parametrize("kind", ["tiled", "dense"])
def test_maps_on_the_mesh_are_bitwise_the_one_process_maps(ranks, one_maps,
                                                           kind):
    for res in ranks:
        assert np.array_equal(res[0][kind], one_maps[kind]), kind


def test_tiles_go_over_the_data_ranks(ranks, one_maps):
    """Each rank maps its data rank's half of the tiles."""
    k = one_maps["pixels"]
    padded = -(-k // (2 * TILE)) * 2 * TILE
    for r, res in enumerate(ranks):
        assert res[0]["calls"] == [TILE] * (padded // 2 // TILE), r


@pytest.fixture(scope="module", params=FUSED)
def fused(request, ranks):
    k = 1 + FUSED.index(request.param)
    return dict(ranks=[r[k] for r in ranks],
                one=tw.TASKS["fused"](None, algo=request.param))


def test_fused_seeds_go_over_the_data_ranks(fused):
    assert [tuple(r["block"]) for r in fused["ranks"]] == [
        (0, 2), (0, 2), (2, 4), (2, 4)]
    for r in fused["ranks"]:
        assert r["whole"] and len(r["states"]) == 2


def test_fused_run_on_the_mesh_matches_the_one_process_fused_run(fused):
    one = fused["one"]
    for r in fused["ranks"]:
        lo, hi = r["block"]
        for k, v in one["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k].numpy(),
                                       v[lo:hi].numpy(), err_msg=k,
                                       **METRIC_TOL)
        for i, st in enumerate(r["states"]):
            want = one["states"][lo + i]
            assert torch.equal(st["generator"], want["generator"])
            assert int(st["step"]) == int(want["step"]) == 8


def test_model_ranks_repeat_their_data_rank_seeds_bitwise(fused):
    a, b = fused["ranks"][0], fused["ranks"][1]
    for sa, sb in zip(a["states"], b["states"]):
        assert set(sa) == set(sb)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_checkpoint_on_the_mesh_is_the_one_process_checkpoint(ranks,
                                                              tmp_path):
    paths = {res[3]["path"] for res in ranks}
    assert len(paths) == 1
    got = dict(tw.leaves(load_params_npz(f"{paths.pop()}/{STATE_FILE}")))
    one = tw.TASKS["checkpoint"](None, tp=2, directory=str(tmp_path))
    want = dict(tw.leaves(load_params_npz(f"{one['path']}/{STATE_FILE}")))
    assert set(got) == set(want)
    assert got["net_b/params/feat_spe/kernel"].shape == (103, 1024)
    for k, v in want.items():
        tol = QUEUE_TOL if k.startswith("queue") else PARAM_TOL
        np.testing.assert_allclose(got[k], v, err_msg=k, **tol)


def test_checkpoint_restores_onto_the_shards_bitwise(ranks):
    for res in ranks:
        c = res[3]
        saved, back = dict(tw.leaves(c["saved"])), dict(tw.leaves(c["restored"]))
        assert set(saved) == set(back)
        for k, v in saved.items():
            assert np.array_equal(back[k], v), k
        assert back["net_b/params/feat_spe/kernel"].shape == (103, 512)
        assert torch.equal(*c["generators"])
        assert c["step"] == 2
