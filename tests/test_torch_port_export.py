"""Export of the whole-scene predictor on the CPU
(``cmlpl_tpu_torch/utils/export.py``, ``cmlpl_tpu_torch/cli/export_model.py``)
against the JAX package's (``cmlpl_tpu/utils/export.py``,
``cmlpl_tpu/cli/export_model.py``), on the 64x48 synthetic scene (n_pc 16,
w 20, tiles of 256).

Both nets of one CMLPL state: the JAX trainer's initial state, carried to
the port by ``state_from_jax`` (``weights.state_dict_from_jax``) and saved
as a port checkpoint.  The port's artifact runs the same eager ops as the
port's ``ScenePredictor``, so their maps are equal bitwise; against JAX's
artifact a pixel may differ only where JAX's two best logits are closer
than ``TIE_GAP`` (f32 sums in another order can swap them).
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.data.patches import gather_patches as jax_gather_patches
from cmlpl_tpu.eval.inference import _dense_logits as jax_dense_logits
from cmlpl_tpu.eval.inference import \
    _dense_params_view as jax_dense_params_view
from cmlpl_tpu.models import BaseNet2 as JaxBaseNet2
from cmlpl_tpu.train import CMLPLConfig as JaxConfig
from cmlpl_tpu.train import CMLPLTrainer as JaxCMLPLTrainer
from cmlpl_tpu.utils import export as jax_export
from cmlpl_tpu_torch.cli import export_model
from cmlpl_tpu_torch.cli._common import logits_fn
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.eval.inference import ScenePredictor
from cmlpl_tpu_torch.models.basenet import BaseNet2
from cmlpl_tpu_torch.train import CMLPLTrainer
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.utils import export
from cmlpl_tpu_torch.utils.checkpoint import save_checkpoint
from cmlpl_tpu_torch.weights import save_params_npz, state_dict_from_jax
from torch_port_threads import one_torch_thread  # noqa: F401

N_PC, W, TILE = 16, 20, 256
TIE_GAP = 1e-5
CASES = [(g, n) for g in ("xla", "dense") for n in ("b", "e")]
CASE_IDS = [f"{g}-net_{n}" for g, n in CASES]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export")
    cube, gt = synthetic_scene(0)
    jscene = jax_prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC)
    scene = prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC,
                          device="cpu")
    tiny = dict(num_classes=9, num_features=103, n_pc=N_PC, patch_size=W,
                labeled_batch=8, unlabeled_batch=16, num_unlabel=64)
    jstate = jax.device_get(
        JaxCMLPLTrainer(JaxConfig(**tiny)).init_state(jax.random.key(3)))
    trainer = CMLPLTrainer(CMLPLConfig(**tiny), device="cpu")
    save_checkpoint(str(tmp / "ck"), trainer, trainer.state_from_jax(jstate))
    jparams = {"b": jstate.net_b.params, "e": jstate.net_e.params}
    save_params_npz(str(tmp / "w_b.npz"), jparams["b"])
    jmodel = JaxBaseNet2(num_features=103, num_classes=9, n_pc=N_PC)

    def jax_apply(p, xp, x):
        return jmodel.apply({"params": p}, xp, x, train=False)[0]

    return dict(tmp=tmp, jscene=jscene, scene=scene, jparams=jparams,
                jax_apply=jax_apply, jax={}, port={})


def port_model(params, compute_dtype="float32"):
    model = BaseNet2(num_features=103, num_classes=9, n_pc=N_PC,
                     patch_size=W, compute_dtype=compute_dtype)
    model.load_state_dict(state_dict_from_jax(params))
    return model.eval()


def jax_artifact(setup, gather, net):
    """(meta, labels) of JAX's exported artifact, built once a case."""
    key = (gather, net)
    if key not in setup["jax"]:
        meta, payload = jax_export.export_scene_predictor(
            setup["jax_apply"], setup["jparams"][net], setup["jscene"],
            gather=gather, tile=TILE, platforms=["cpu"])
        path = str(setup["tmp"] / f"jax_{gather}_{net}.zip")
        jax_export.save_exported(path, meta, payload)
        meta, fn = jax_export.load_exported(path)
        jscene = setup["jscene"]
        setup["jax"][key] = meta, fn(jscene.padded_pca, jscene.spectra)
    return setup["jax"][key]


def port_artifact(setup, gather, net):
    """(meta, labels, model) of the port's artifact, built once a case."""
    key = (gather, net)
    if key not in setup["port"]:
        model = port_model(setup["jparams"][net])
        meta, payload = export.export_scene_predictor(
            model, None, setup["scene"], gather=gather, tile=TILE)
        path = str(setup["tmp"] / f"port_{gather}_{net}.zip")
        export.save_exported(path, meta, payload)
        meta, fn = export.load_exported(path)
        scene = setup["scene"]
        setup["port"][key] = (meta, fn(scene.padded_pca, scene.spectra),
                              model)
    return setup["port"][key]


def jax_gaps(setup, gather, net, pixels):
    """JAX's top-2 logit gaps at ``pixels`` in the artifact's mode."""
    jscene, params = setup["jscene"], setup["jparams"][net]
    if gather == "dense":
        logits = np.asarray(jax_dense_logits(
            jax_dense_params_view(params), jscene.padded_pca, jscene.spectra,
            jscene.rows, jscene.cols, W))[pixels]
    else:
        idx = jnp.asarray(pixels, jnp.int32)
        xp = jax_gather_patches(jscene.padded_pca, idx, cols=jscene.cols,
                                w=W)
        logits = np.asarray(setup["jax_apply"](params, xp,
                                               jscene.spectra[idx]))
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def assert_tie_safe(setup, gather, net, got, want):
    assert got.shape == want.shape and got.dtype == np.int32
    diff = np.nonzero(got != want)[0]
    if diff.size:
        gaps = jax_gaps(setup, gather, net, diff)
        assert (gaps < TIE_GAP).all(), (diff, gaps)


@pytest.mark.parametrize("gather,net", CASES, ids=CASE_IDS)
def test_artifact_matches_jax_artifact(setup, gather, net):
    _, want = jax_artifact(setup, gather, net)
    _, got, _ = port_artifact(setup, gather, net)
    assert_tie_safe(setup, gather, net, got, want)


@pytest.mark.parametrize("gather,net", CASES, ids=CASE_IDS)
def test_artifact_equals_scene_predictor(setup, gather, net):
    _, got, model = port_artifact(setup, gather, net)
    scene = setup["scene"]
    want = ScenePredictor(logits_fn(model), params=model.state_dict(),
                          patch_size=W, cols=scene.cols, tile=TILE,
                          gather=gather)(scene)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gather", ["xla", "dense"])
def test_meta_matches_jax(setup, gather):
    jmeta, _ = jax_artifact(setup, gather, "b")
    meta, _, _ = port_artifact(setup, gather, "b")
    assert set(meta) == set(jmeta) - {"jax_version"} | {"torch_version",
                                                         "compute_dtype"}
    for key in set(meta) & set(jmeta):
        assert meta[key] == jmeta[key], key
    assert meta["platforms"] == ["cpu"]
    assert meta["torch_version"] == torch.__version__
    assert meta["compute_dtype"] == "float32"
    assert export.read_meta(str(setup["tmp"] / f"port_{gather}_b.zip")) \
        == meta


def test_bf16_artifact_equals_its_scene_predictor(setup):
    model = port_model(setup["jparams"]["b"], "bfloat16")
    scene = setup["scene"]
    meta, payload = export.export_scene_predictor(model, None, scene,
                                                  gather="xla", tile=TILE)
    assert meta["compute_dtype"] == "bfloat16"
    path = str(setup["tmp"] / "port_bf16.zip")
    export.save_exported(path, meta, payload)
    _, fn = export.load_exported(path)
    want = ScenePredictor(logits_fn(model), patch_size=W, cols=scene.cols,
                          tile=TILE, gather="xla")(scene)
    np.testing.assert_array_equal(fn(scene.padded_pca, scene.spectra), want)


def test_graph_holds_one_net_and_a_loop(setup):
    """The tile loop is one loop operator, not one net a tile."""
    port_artifact(setup, "xla", "b")
    _, exported = export._load_raw(str(setup["tmp"] / "port_xla_b.zip"))
    gm = exported.graph_module
    loops = [n for n in gm.graph.nodes
             if n.op == "call_function" and "while_loop" in str(n.target)]
    assert len(loops) == 1
    convs = [n for n in gm.graph.nodes
             if n.op == "call_function" and "conv" in str(n.target)]
    assert convs == []      # the convolutions live in the loop's body
    assert len(exported.graph_signature.user_inputs) == 2


def test_load_exported_takes_numpy_and_refuses_another_device(setup):
    meta, want, _ = port_artifact(setup, "dense", "b")
    _, fn = export.load_exported(str(setup["tmp"] / "port_dense_b.zip"))
    scene = setup["scene"]
    got = fn(scene.padded_pca.numpy(), scene.spectra.numpy())
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="is on meta, the artifact runs on"):
        fn(torch.empty(scene.padded_pca.shape, device="meta"),
           scene.spectra)
    with pytest.raises(ValueError, match="runs on cpu, not on cuda"):
        export.load_exported(str(setup["tmp"] / "port_dense_b.zip"),
                             device="cuda")
    _, fn = export.load_exported(str(setup["tmp"] / "port_dense_b.zip"),
                                 device="cpu")
    np.testing.assert_array_equal(fn(scene.padded_pca, scene.spectra), want)


@pytest.mark.parametrize("gather", ["pallas", "pallas_bf16", "auto"])
def test_kernel_modes_are_refused(setup, gather):
    with pytest.raises(ValueError, match="ctypes launches"):
        export.build_exported(port_model(setup["jparams"]["b"]), None,
                              setup["scene"], gather=gather)


# ------------------------------------------------------------------ the CLI

def cli_argv(setup, *extra):
    return ["--dataID", "0", "--n_PC", str(N_PC), "--w", str(W),
            "--val_batch_size", str(TILE), "--device", "cpu",
            "--data_root", str(setup["tmp"]), *extra]


def run_cli(argv, capsys):
    out = export_model.main(argv)
    return out, capsys.readouterr().out


@pytest.mark.parametrize("net", ["b", "e"])
def test_cli_verify_from_a_checkpoint(setup, capsys, net):
    out = str(setup["tmp"] / f"cli_{net}.zip")
    _, text = run_cli(cli_argv(setup, "--checkpoint_dir",
                               str(setup["tmp"] / "ck"), "--net", net,
                               "--out", out, "--verify"), capsys)
    assert "agreement vs in-process predictor: 1.00000" in text
    assert "artifact inference time == " in text
    meta, fn = export.load_exported(out)
    assert (meta["gather"], meta["net"], meta["dataID"]) == ("xla", net, 0)
    scene = setup["scene"]
    _, want = jax_artifact(setup, "xla", net)
    assert_tie_safe(setup, "xla", net, fn(scene.padded_pca, scene.spectra),
                    want)


def test_cli_verify_from_weights_dense(setup, capsys):
    out = str(setup["tmp"] / "cli_w.zip")
    _, text = run_cli(cli_argv(setup, "--weights",
                               str(setup["tmp"] / "w_b.npz"), "--out", out,
                               "--eval_gather", "dense", "--platform", "cpu",
                               "--verify"), capsys)
    assert "agreement vs in-process predictor: 1.00000" in text
    meta, fn = export.load_exported(out)
    assert (meta["gather"], meta["platforms"]) == ("dense", ["cpu"])
    _, want, _ = port_artifact(setup, "dense", "b")
    scene = setup["scene"]
    np.testing.assert_array_equal(fn(scene.padded_pca, scene.spectra), want)


@pytest.mark.parametrize("platform", [["tpu"], ["cpu", "cuda"], ["cpu",
                                                                 "tpu"]],
                         ids=["tpu", "two", "cpu_and_tpu"])
def test_cli_refuses_platforms(setup, platform):
    with pytest.raises(SystemExit, match="--platform"):
        export_model.main(cli_argv(setup, "--weights",
                                   str(setup["tmp"] / "w_b.npz"),
                                   "--platform", *platform))


@pytest.mark.parametrize("gather", ["pallas", "pallas_bf16"])
def test_cli_refuses_kernel_modes(setup, gather):
    with pytest.raises(SystemExit, match="cannot be exported"):
        export_model.main(cli_argv(setup, "--weights",
                                   str(setup["tmp"] / "w_b.npz"),
                                   "--eval_gather", gather))


def test_cli_needs_one_source_of_weights(setup):
    with pytest.raises(SystemExit, match="give one of --weights and "
                       "--checkpoint_dir"):
        export_model.main(cli_argv(setup, "--out",
                                   str(setup["tmp"] / "none.zip")))


def test_entry_point_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_model.main(["--dataID", "0", "--weights", "unused.npz"])


def test_signature_names_and_shapes(setup):
    """The bundle's signature in the JAX bundle's grammar and order
    (cube, spectra -> labels), with the scene's shapes."""
    port_artifact(setup, "xla", "b")
    _, exported = export._load_raw(str(setup["tmp"] / "port_xla_b.zip"))
    scene = setup["scene"]
    k, bands = scene.spectra.shape
    hp, wp, c = scene.padded_pca.shape
    assert export.signature_lines(exported) == [
        f"input padded_cube f32 {hp},{wp},{c}",
        f"input spectra f32 {k},{bands}", f"output labels i32 {k}"]
    jmeta, _ = jax_artifact(setup, "xla", "b")
    assert [hp, wp, c] == jmeta["cube_shape"]
    assert json.loads(json.dumps(jmeta))["spectra_shape"] == [k, bands]


def test_meta_json_in_zip_is_plain_json(setup):
    import zipfile

    port_artifact(setup, "xla", "b")
    with zipfile.ZipFile(str(setup["tmp"] / "port_xla_b.zip")) as z:
        assert sorted(z.namelist()) == ["meta.json", "model.pt2"]
        meta = json.load(io.BytesIO(z.read("meta.json")))
    assert meta["format_version"] == jax_export.FORMAT_VERSION
