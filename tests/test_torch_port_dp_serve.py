"""``predict`` and ``serve`` over two gloo ranks on the CPU
(``--multihost``; ``cmlpl_tpu/cli/predict.py:36-52``,
``cmlpl_tpu/cli/serve.py:54-79``).

``predict --multihost`` from ``--weights`` and from a port
``--checkpoint_dir``, in ``xla`` and ``dense``: rank 0 reads the weights
and prepares the scene, both are broadcast, each rank maps its strip, and
the map on both ranks is bitwise the one-process ``predict``'s; rank 0
alone writes ``--out``.  The maps are tie-safe equal to JAX's
``ScenePredictor`` on a two-device mesh (a pixel may differ only where
JAX's two best logits lie closer than ``TIE_GAP``, as in
``tests/test_torch_port_dp_map.py``).

``serve --multihost`` fed a good request, a bad one (a missing file), one
of another geometry, a blank line, a cube of other bands (refused on rank
0), a one-row scene (dense: rank 0's strip is empty) and the first
geometry again: rank 0's
stdout is the one-process ``serve``'s, field by field but for the times,
the other rank writes nothing to stdout and reads nothing of its stdin,
the ``.npy`` outputs are bitwise the one-process outputs, and both ranks
return.  ``core/mesh.broadcast_scene`` gives rank 1 a scene bitwise rank
0's.

``serve --multihost --model dbda`` (a zoo model of patches alone, from
weights drawn as the benchmark draws them) maps a 12 x 12 cube bitwise
as one process does; under a profiler each rank records one
``serve.broadcast`` span a mapped request and one ``map.tile`` span a
tile of its strip.

Every two-rank case runs in one world (``torch_dist_worker.task_many``).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmlpl_tpu.core.mesh import create_mesh as jax_create_mesh
from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.data.patches import gather_patches as jax_gather_patches
from cmlpl_tpu.eval import ScenePredictor as JaxScenePredictor
from cmlpl_tpu.eval.inference import dense_scene_logits as jax_dense
from cmlpl_tpu.models import BaseNet2 as JaxBaseNet2
from cmlpl_tpu_torch.cli._common import base_parser, export_parser
from cmlpl_tpu_torch.core.mesh import broadcast_scene, create_mesh
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.train import CMLPLTrainer
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.utils.checkpoint import load_net_params, save_checkpoint
from cmlpl_tpu_torch.weights import (init_basenet2_params, save_params_npz,
                                     zoo_variables_to_jax)
from portbench import scenes
from portbench.drivers.serve_zoo import zoo_weights
from portbench.reference import dbda as ref_dbda
from torch_dist_worker import N_PC, W, run_ranks, task_serve, tiny_scene
from torch_port_threads import one_torch_thread  # noqa: F401

TILE = 256
TIE_GAP = 1e-5
PIXELS = 64 * 48
SOURCES = ("weights", "checkpoint")
GATHERS = ("xla", "dense")
CASES = [(s, g) for s in SOURCES for g in GATHERS]
#: serve's cases: the default gather with the warm-up, dense without
SERVE = {"auto": [], "dense": ["--no_warmup"]}
#: the requests' ids and their outputs; "bad" names a missing cube,
#: "bands" a cube of 102 bands where the dataset has 103
REQUESTS = ("good", "bad", "crop", "bands", "row", "back")
#: the requests that rank 0 answers with an error, and its type
ERRORS = {"bad": "FileNotFoundError", "bands": "ValueError"}
#: each request's pixels (None: an error)
PIXELS_OF = {"good": PIXELS, "crop": 40 * 30, "row": 30, "back": PIXELS}
TIMES = ("latency_s", "warmup_s")
#: DBDA's requests: a 12 x 12 cube twice, 5 x 5 patches, 64 pixels a tile
#: (on two ranks each maps two tiles of the 256 padded pixels)
DBDA_W, DBDA_TILE, DBDA_REQUESTS = 5, 64, ("a", "b")


def _source(tmp, source):
    return (["--weights", str(tmp / "w.npz")] if source == "weights"
            else ["--checkpoint_dir", str(tmp / "ck")])


def _argv(tmp, source, gather, *extra):
    return ["--dataID", "0", "--n_PC", str(N_PC), "--w", str(W),
            "--val_batch_size", str(TILE), "--device", "cpu",
            "--eval_gather", gather, *_source(tmp, source), *extra]


def _dbda_argv(tmp, *extra):
    return ["--dataID", "0", "--model", "dbda", "--weights",
            str(tmp / "dbda.npz"), "--w", str(DBDA_W), "--val_batch_size",
            str(DBDA_TILE), "--device", "cpu", "--no_warmup", *extra]


def _dbda_stdin(tmp):
    return "".join(json.dumps({"id": k, "cube": str(tmp / "dbda_cube.npy"),
                               "out": str(tmp / "serve_dbda" / f"{k}.npy")})
                   + "\n" for k in DBDA_REQUESTS)


def _stdin(tmp, gather):
    out = tmp / f"serve_{gather}"
    reqs = {"good": tmp / "cube.npy", "bad": tmp / "missing.npy",
            "crop": tmp / "crop.npy", "bands": tmp / "bands.npy",
            "row": tmp / "row.npy", "back": tmp / "cube.npy"}
    lines = [json.dumps({"id": k, "cube": str(c),
                         "out": str(out / f"{k}.npy")})
             for k, c in reqs.items()]
    lines.insert(3, "")
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process runs, then the same runs on two ranks (one world),
    their serve outputs written where the one-process outputs were, which
    are moved to ``serve_<gather>_one``."""
    tmp = tmp_path_factory.mktemp("dp_serve")
    save_params_npz(str(tmp / "w.npz"), init_basenet2_params(
        11, n_pc=N_PC, num_features=103, num_classes=9, patch_size=W))
    trainer = CMLPLTrainer(CMLPLConfig(num_features=103, n_pc=N_PC,
                                       patch_size=W), device="cpu")
    save_checkpoint(str(tmp / "ck"), trainer, trainer.init_state(5))
    cube, _ = synthetic_scene(0)
    np.save(tmp / "cube.npy", cube)
    np.save(tmp / "crop.npy", cube[:40, :30])
    np.save(tmp / "bands.npy", cube[:, :, :102])
    np.save(tmp / "row.npy", cube[:1, :30])
    np.save(tmp / "dbda_cube.npy", cube[:12, :12])
    save_params_npz(str(tmp / "dbda.npz"), zoo_variables_to_jax(
        "dbda", zoo_weights(scenes.streams(7, 1)[0],
                            ref_dbda.shapes(103, 9), "cpu")))
    outs = [*SERVE, "dbda"]
    for g in outs:
        os.makedirs(tmp / f"serve_{g}")
    one = task_serve(
        None,
        predict_runs=[_argv(tmp, s, g, "--out", str(tmp / f"one_{s}_{g}.svg"))
                      for s, g in CASES],
        serve_runs=[(_argv(tmp, "weights", g, *extra), _stdin(tmp, g))
                    for g, extra in SERVE.items()]
        + [(_dbda_argv(tmp), _dbda_stdin(tmp))])
    for g in outs:
        os.rename(tmp / f"serve_{g}", tmp / f"serve_{g}_one")
        os.makedirs(tmp / f"serve_{g}")
    predict_runs = [[_argv(tmp, s, g, "--multihost", "--out",
                           str(tmp / f"r{r}_{s}_{g}.svg")) for r in range(2)]
                    for s, g in CASES]
    serve_runs = [(_argv(tmp, "weights", g, "--multihost", *extra),
                   _stdin(tmp, g)) for g, extra in SERVE.items()] + [
        (_dbda_argv(tmp, "--multihost"), _dbda_stdin(tmp))]
    calls = [["serve", dict(predict_runs=predict_runs,
                            serve_runs=serve_runs)],
             ["raises", dict(module="predict", cwd=str(tmp), argv=_argv(
                 tmp, "weights", "xla", "--multihost", "--weights",
                 str(tmp / "none.npz")))],
             ["serve_spans", dict(argv=_dbda_argv(tmp, "--multihost"),
                                  text=_dbda_stdin(tmp))]]
    ranks = run_ranks("many", str(tmp / "ranks"), calls=calls)
    return dict(tmp=tmp, one=one, ranks=[r[0] for r in ranks],
                raises=[r[1] for r in ranks], spans=[r[2] for r in ranks])


@pytest.fixture(scope="module")
def jax_maps(runs):
    """JAX's maps over a two-device mesh of each case's params, and each
    case's ``pixels -> gaps`` between JAX's two best logits."""
    cube, gt = synthetic_scene(0)
    jscene = jax_prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC)
    mesh2 = jax_create_mesh(jax.devices()[:2])
    jmodel = JaxBaseNet2(num_features=103, num_classes=9, n_pc=N_PC)

    def apply(p, xp, x):
        return jmodel.apply({"params": p}, xp, x, train=False)[0]

    trees = {"weights": init_basenet2_params(11, n_pc=N_PC, num_features=103,
                                             num_classes=9, patch_size=W),
             "checkpoint": load_net_params(str(runs["tmp"] / "ck"), "b")}
    out = {}
    for source, gather in CASES:
        tree = trees[source]
        if gather == "dense":
            jmap = JaxScenePredictor(None, patch_size=W, cols=jscene.cols,
                                     gather="dense", mesh=mesh2)(tree, jscene)
            logits = np.asarray(jax_dense(tree, jscene))

            def gaps(pixels, logits=logits):
                top2 = np.sort(logits[pixels], axis=-1)[:, -2:]
                return top2[:, 1] - top2[:, 0]
        else:
            jmap = JaxScenePredictor(apply, patch_size=W, cols=jscene.cols,
                                     tile=TILE, gather="xla", mesh=mesh2)(
                tree, jscene)

            def gaps(pixels, tree=tree):
                idx = jnp.asarray(pixels, jnp.int32)
                xp = jax_gather_patches(jscene.padded_pca, idx,
                                        cols=jscene.cols, w=W)
                top2 = np.sort(np.asarray(apply(tree, xp,
                                                jscene.spectra[idx])),
                               axis=-1)[:, -2:]
                return top2[:, 1] - top2[:, 0]
        out[source, gather] = (np.asarray(jmap), gaps)
    return out


def test_predict_and_serve_take_multihost():
    assert base_parser().parse_args(["--multihost"]).multihost
    assert not base_parser().parse_args([]).multihost
    # train's parser defines the flag once; export_model's reads both
    assert export_parser().parse_args(["--multihost"]).multihost


@pytest.mark.parametrize("source,gather", CASES)
def test_predict_map_is_bitwise_the_one_process_map(runs, source, gather):
    want = runs["one"]["predict"][CASES.index((source, gather))]["labels"]
    assert want.shape == (PIXELS,) and want.dtype == np.int32
    for r in runs["ranks"]:
        np.testing.assert_array_equal(
            r["predict"][CASES.index((source, gather))]["labels"], want)


@pytest.mark.parametrize("source,gather", CASES)
def test_predict_rank_0_alone_writes_out(runs, source, gather):
    tmp = runs["tmp"]
    assert ((tmp / f"r0_{source}_{gather}.svg").read_bytes()
            == (tmp / f"one_{source}_{gather}.svg").read_bytes())
    assert not (tmp / f"r1_{source}_{gather}.svg").exists()


@pytest.mark.parametrize("source,gather", CASES)
def test_predict_map_matches_the_jax_mesh_map(runs, jax_maps, source,
                                              gather):
    got = runs["ranks"][0]["predict"][CASES.index((source, gather))]["labels"]
    want, gaps = jax_maps[source, gather]
    assert got.shape == want.shape
    diff = np.nonzero(got != want)[0]
    if diff.size:
        assert (gaps(diff) < TIE_GAP).all(), (diff, gaps(diff))


def _lines(text, *starts):
    return [ln for ln in text.splitlines() if ln.startswith(starts)]


@pytest.mark.parametrize("source,gather", CASES)
def test_predict_every_rank_prints_its_results(runs, source, gather):
    printed = [r["predict"][CASES.index((source, gather))]["printed"]
               for r in runs["ranks"]]
    one = runs["one"]["predict"][CASES.index((source, gather))]["printed"]
    name = "weights" if source == "weights" else "net B"
    for text in printed:
        assert "multihost: 2 process(es)" in text
        assert f"classified {PIXELS} pixels in" in text
        assert (_lines(text, "Result", " OA=", "producerA", "AA=")
                == _lines(one, "Result", " OA=", "producerA", "AA="))
        assert f"Result ({name})" in text
    assert "wrote " in printed[0] and "wrote " not in printed[1]


def _responses(text):
    return [json.loads(ln) for ln in text.splitlines()]


@pytest.mark.parametrize("gather", list(SERVE))
def test_serve_rank_0_answers_as_one_process(runs, gather):
    i = list(SERVE).index(gather)
    got = _responses(runs["ranks"][0]["serve"][i]["stdout"])
    want = _responses(runs["one"]["serve"][i]["stdout"])
    assert len(got) == len(want) == 1 + len(REQUESTS)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert {k: v for k, v in g.items() if k not in TIMES} == \
            {k: v for k, v in w.items() if k not in TIMES}
        assert all(g[k] >= 0 for k in TIMES if k in g)
    assert got[0]["ready"] is True
    assert ("warmup_s" in got[0]) == (gather == "auto")
    assert [g.get("id") for g in got[1:]] == list(REQUESTS)
    for g, name in zip(got[1:], REQUESTS):
        assert g.get("error", "").startswith(ERRORS.get(name, "-")) == (
            name in ERRORS)
    assert [g.get("pixels") for g in got[1:]] == [PIXELS_OF.get(k)
                                                  for k in REQUESTS]


@pytest.mark.parametrize("gather", list(SERVE))
def test_serve_other_ranks_write_and_read_nothing(runs, gather):
    i = list(SERVE).index(gather)
    r0, r1 = (r["serve"][i] for r in runs["ranks"])
    assert r1["stdout"] == ""
    assert r1["stdin_read"] == 0
    assert r0["stdin_read"] == len(_stdin(runs["tmp"], gather))


@pytest.mark.parametrize("gather", list(SERVE))
def test_serve_outputs_are_bitwise_the_one_process_outputs(runs, gather):
    tmp = runs["tmp"]
    for name in REQUESTS:
        got = tmp / f"serve_{gather}" / f"{name}.npy"
        want = tmp / f"serve_{gather}_one" / f"{name}.npy"
        assert got.exists() == want.exists() == (name not in ERRORS)
        if name not in ERRORS:
            assert got.read_bytes() == want.read_bytes()
    np.testing.assert_array_equal(
        np.load(tmp / f"serve_{gather}" / "good.npy"),
        runs["ranks"][0]["predict"][CASES.index(("weights", "xla"
                                                 if gather == "auto"
                                                 else "dense"))]["labels"])


@pytest.mark.parametrize("gather", list(SERVE))
def test_serve_broadcasts_each_mapped_scene(runs, gather):
    """One broadcast a map (the warm-up's too), none for the requests
    answered with an error; bytes: the padded PCA cube and spectra (f32)
    and the labels."""
    i = list(SERVE).index(gather)
    full = 2 + (gather == "auto")

    def scene_bytes(rows, cols):
        return ((rows + W) * (cols + W) * N_PC + rows * cols * 104) * 4

    want = (full + 2, full * scene_bytes(64, 48) + scene_bytes(40, 30)
            + scene_bytes(1, 30))
    for r in runs["ranks"]:
        assert r["serve"][i]["broadcasts"] == want
    assert runs["one"]["serve"][i]["broadcasts"] == (0, 0)


@pytest.mark.parametrize("gather", list(SERVE))
def test_serve_refuses_a_cube_of_other_bands_on_rank_0(runs, gather):
    """The cube of 102 bands is refused in rank 0's prep with the cube's
    shape in the message (the map would fail on every rank), and both
    ranks map the next requests."""
    i = list(SERVE).index(gather)
    got = _responses(runs["ranks"][0]["serve"][i]["stdout"])
    bands = got[1 + REQUESTS.index("bands")]
    assert bands == {"id": "bands", "error": "ValueError: cube of shape "
                     "(64, 48, 102), want (rows, cols, 103) for Synthetic"}
    assert [g["pixels"] for g in got[2 + REQUESTS.index("bands"):]] == [
        30, PIXELS]


def _bits(t):
    return t.view(torch.int32)


def test_broadcast_scene_gives_every_rank_rank_0s_scene(runs):
    s0, s1 = (r["scene"] for r in runs["ranks"])
    local = tiny_scene()[0]
    for s in (s0, s1):
        for name in ("padded_pca", "spectra"):
            assert s[name].dtype == torch.float32
            assert torch.equal(_bits(s[name]),
                               _bits(getattr(local, name)))
        np.testing.assert_array_equal(s["labels"], local.labels)
        assert (s["patch_size"], s["n_pc"]) == (local.patch_size,
                                                local.n_pc)
        for f in dataclasses.fields(local.spec):
            np.testing.assert_array_equal(getattr(s["spec"], f.name),
                                          getattr(local.spec, f.name))
    assert s0["broadcasts"] == s1["broadcasts"] == (1, (
        (64 + W) * (48 + W) * N_PC + PIXELS * 103 + PIXELS) * 4)


def test_broadcast_scene_without_a_group_is_the_scene():
    scene = tiny_scene()[0]
    assert broadcast_scene(scene, None) is scene
    assert broadcast_scene(scene, create_mesh("cpu")) is scene


def test_a_weights_file_rank_0_cannot_read_fails_every_rank(runs):
    r0, r1 = runs["raises"]
    assert r0["type"] == r1["type"] == "FileNotFoundError"
    assert r0["msg"] == r1["msg"] and "none.npz" in r0["msg"]


def test_serve_dbda_over_two_ranks_is_bitwise_the_one_process_map(runs):
    tmp = runs["tmp"]
    for k in DBDA_REQUESTS:
        want = (tmp / "serve_dbda_one" / f"{k}.npy").read_bytes()
        assert (tmp / "serve_dbda" / f"{k}.npy").read_bytes() == want
    labels = np.load(tmp / "serve_dbda_one" / "a.npy")
    assert labels.shape == (144,) and len(np.unique(labels)) > 1
    got = _responses(runs["ranks"][0]["serve"][len(SERVE)]["stdout"])
    assert [g.get("pixels") for g in got[1:]] == [144, 144]
    assert runs["ranks"][1]["serve"][len(SERVE)]["stdout"] == ""


def test_serve_records_a_broadcast_a_request_and_a_span_a_tile(runs):
    # rank 0 alone reads the requests
    assert runs["spans"][0]["serve.request"] == len(DBDA_REQUESTS)
    assert "serve.request" not in runs["spans"][1]
    for counts in runs["spans"]:
        assert counts["serve.broadcast"] == len(DBDA_REQUESTS)
        # 144 pixels padded to 256 over two ranks: two tiles a rank a map
        assert counts["map.tile"] == 2 * len(DBDA_REQUESTS)
