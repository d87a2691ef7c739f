"""The dense map split into strips of scene rows, and
``cli.train_backbone --multihost``, on the CPU.

Dense strips (``eval/inference.py``: ``strip_rows``,
``dense_strip_logits``, ``ScenePredictor(gather="dense", mesh=)``): in
one process, every split of a 61-row crop of the synthetic scene into 1
to 5 strips (61 rows divide over none of 2 to 5) gives the whole pass's
logits within rtol 1e-5 (measured: 1.2e-7 at most, the convolutions
summing over other shapes) and its labels where the two best logits do
not tie; over two gloo ranks the map equals the one-process dense map
and, tie-safe, JAX's dense map over a two-device mesh (GSPMD's row
sharding of the padded cube), for BaseNet2 and CCT weights.

The CLI on two ranks: every rank prints the same epoch and OA lines,
rank 0 alone writes the CSV, the SVG, ``--metrics_csv`` and
``--weights_out``, ``--resume`` restarts both ranks from rank 0's
checkpoint, and ``--gather_impl pallas`` asked for by name is refused.

Every two-rank case runs in one world (``torch_dist_worker.task_many``).
"""

import os

import jax
import numpy as np
import pytest

from cmlpl_tpu.core.mesh import create_mesh as jax_create_mesh
from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.eval import ScenePredictor as JaxScenePredictor
from cmlpl_tpu.eval.inference import dense_scene_logits as jax_dense
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.eval.inference import (dense_scene_logits,
                                            dense_strip_logits, strip_rows)
from cmlpl_tpu_torch.weights import (init_basenet2_params, init_cct_params,
                                     state_dict_from_jax)
from torch_dist_worker import N_PC, W, dense_scene, run_ranks
from torch_port_threads import one_torch_thread  # noqa: F401

ROWS, COLS = 61, 23
SEEDS = {"basenet2": 7, "cct": 8}
INIT = {"basenet2": init_basenet2_params, "cct": init_cct_params}
SHAPE = dict(n_pc=N_PC, num_features=103, num_classes=9, patch_size=W)
STRIP_TOL = dict(rtol=1e-5, atol=1e-6)
#: a label may differ only where the two best logits lie closer than
#: this: f32 sums in another order can swap them (the dense tests' gap
#: against JAX, ``tests/test_torch_port_dense.py``)
TIE_GAP = 1e-4
CLI = ["--dataID", "0", "--model", "ssftt", "--device", "cpu",
       "--multihost", "--val_batch_size", "1024"]


def _tie_safe_equal(got, logits):
    """``got`` is the argmax of ``logits`` but where the top two tie."""
    logits = np.asarray(logits)
    diff = np.nonzero(got != logits.argmax(-1))[0]
    top2 = np.sort(logits[diff], axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] < TIE_GAP).all(), diff


@pytest.fixture(scope="module")
def scene():
    return dense_scene(ROWS, COLS)


@pytest.fixture(scope="module")
def params():
    return {k: state_dict_from_jax(INIT[k](s, **SHAPE))
            for k, s in SEEDS.items()}


@pytest.fixture(scope="module")
def whole(scene, params):
    return {k: dense_scene_logits(p, scene) for k, p in params.items()}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The dense maps and the CLI runs on the same two ranks (one
    world)."""
    tmp = tmp_path_factory.mktemp("dp_dense")
    cwd = tmp / "cwd"
    cwd.mkdir()
    ckpt = str(tmp / "ckpt")

    def per_rank(*extra):
        return [CLI + ["--save_path_prefix", str(tmp / f"out{r}"),
                       "--metrics_csv", str(tmp / f"m{r}.csv"),
                       "--weights_out", str(tmp / f"w{r}.npz"), *extra]
                for r in range(2)]

    runs = [["train_backbone", per_rank(
                "--num_epochs", "2", "--checkpoint_dir", ckpt,
                "--checkpoint_every", "1")],
            ["train_backbone", CLI + [
                "--num_epochs", "3", "--checkpoint_dir", ckpt, "--resume",
                "--save_path_prefix", str(tmp / "resumed")]]]
    calls = [["dense", dict(seeds=SEEDS, rows=ROWS, cols=COLS)],
             ["cli", dict(runs=runs, cwd=str(cwd))],
             ["raises", dict(module="train_backbone",
                             argv=CLI + ["--num_epochs", "1",
                                         "--gather_impl", "pallas"],
                             cwd=str(cwd))]]
    ranks = run_ranks("many", str(tmp / "ranks"), calls=calls)
    return dict(tmp=tmp, dense=[r[0] for r in ranks],
                cli=[r[1] for r in ranks], raises=[r[2] for r in ranks])


@pytest.mark.parametrize("ranks", [1, 2, 3, 4, 5])
def test_strips_cover_the_rows_in_order(ranks):
    strips = [strip_rows(ROWS, ranks, r) for r in range(ranks)]
    assert strips[0][0] == 0 and strips[-1][1] == ROWS
    assert all(a[1] == b[0] for a, b in zip(strips, strips[1:]))
    sizes = [hi - lo for lo, hi in strips]
    assert max(sizes) - min(sizes) <= 1
    assert strip_rows(610, 3, 2) == (406, 610)


@pytest.mark.parametrize("kind", list(SEEDS))
@pytest.mark.parametrize("ranks", [1, 2, 3, 4, 5])
def test_every_split_matches_the_whole_pass(scene, params, whole, kind,
                                            ranks):
    """The strips' logits, concatenated, are the whole pass's within
    rounding, and their labels its labels but where the top two tie."""
    parts = [dense_strip_logits(params[kind], scene,
                                *strip_rows(ROWS, ranks, r))
             for r in range(ranks)]
    assert [p.shape for p in parts] == [
        ((hi - lo) * COLS, 9) for lo, hi in (strip_rows(ROWS, ranks, r)
                                             for r in range(ranks))]
    got = np.concatenate([p.numpy() for p in parts])
    want = whole[kind].numpy()
    np.testing.assert_allclose(got, want, **STRIP_TOL)
    _tie_safe_equal(got.argmax(-1), want)


def test_a_strip_outside_the_scene_is_refused(scene, params):
    with pytest.raises(ValueError, match="outside the scene"):
        dense_strip_logits(params["basenet2"], scene, 50, ROWS + 1)


@pytest.mark.parametrize("kind", list(SEEDS))
def test_two_rank_dense_map_is_the_one_process_map(two_ranks, whole, kind):
    want = whole[kind].numpy()
    maps = [r[kind] for r in two_ranks["dense"]]
    assert maps[0].shape == (ROWS * COLS,) and maps[0].dtype == np.int32
    np.testing.assert_array_equal(maps[0], maps[1])
    _tie_safe_equal(maps[0], want)


@pytest.mark.parametrize("kind", list(SEEDS))
def test_two_rank_dense_map_matches_the_jax_mesh_map(two_ranks, kind):
    cube, gt = synthetic_scene(0)
    jscene = jax_prepare_scene(0, cube=cube[:ROWS, :COLS],
                               gt=gt[:ROWS, :COLS], patch_size=W, n_pc=N_PC)
    tree = INIT[kind](SEEDS[kind], **SHAPE)
    jmap = JaxScenePredictor(None, patch_size=W, cols=COLS, gather="dense",
                             mesh=jax_create_mesh(jax.devices()[:2]))(
        tree, jscene)
    got = two_ranks["dense"][0][kind]
    assert got.shape == jmap.shape
    _tie_safe_equal(got, np.asarray(jax_dense(tree, jscene)))
    _tie_safe_equal(jmap, np.asarray(jax_dense(tree, jscene)))


def _lines(text, *starts):
    return [ln for ln in text.splitlines() if ln.startswith(starts)]


def test_cli_ranks_print_the_same_results(two_ranks):
    r0, r1 = two_ranks["cli"]
    assert r0["oa"] == r1["oa"] and len(r0["oa"]) == 2
    for a, b in zip(r0["printed"], r1["printed"]):
        assert "multihost: 2 process(es)" in a
        want = _lines(a, "Epoch", "Result", " OA=", "AA=", "resumed")
        assert want and want == _lines(b, "Epoch", "Result", " OA=", "AA=",
                                       "resumed")
    assert all(0.0 <= oa[0] <= 1.0 for oa in r0["oa"])


def test_cli_rank_0_alone_writes_the_files(two_ranks):
    tmp = two_ranks["tmp"]
    written = [f for _, _, fs in os.walk(tmp / "out0") for f in fs]
    assert "ssftt_results.csv" in written
    assert any(f.startswith("ssftt_OA_") and f.endswith(".svg")
               for f in written)
    assert (tmp / "m0.csv").exists() and (tmp / "w0.npz").exists()
    assert not (tmp / "out1").exists()
    assert not (tmp / "m1.csv").exists() and not (tmp / "w1.npz").exists()
    assert sorted(os.listdir(tmp / "ckpt")) == ["1", "2", "3"]


def test_cli_resume_restarts_both_ranks_from_rank_0s_checkpoint(two_ranks):
    """45 labels on two ranks: batches of 44, one step an epoch; the
    resumed run restarts at step 2 (epoch 2) and trains its third."""
    for r in two_ranks["cli"]:
        resumed = r["printed"][1]
        assert "resumed from step 2 (epoch 2)" in resumed
        assert "training time" in resumed and "(1 steps)" in resumed
        first = r["printed"][0]
        assert "(2 steps)" in first


def test_cli_refuses_a_kernel_gather_by_name_over_ranks(two_ranks):
    for r in two_ranks["raises"]:
        assert r["type"] == "ValueError"
        assert "gather_impl='pallas' requires a single-rank mesh" in r["msg"]
