"""The training-run bundle (``cmlpl_tpu_torch/utils/export.py``
``build_run_exported``/``save_run_bundle``/``load_run_outputs``,
``cli/export_model.py --train_bundle/--import_run``) against the eager
trainer and the JAX package's bundle (``cmlpl_tpu/utils/export.py:183-350``,
``tests/test_export.py:70-156``).

At the tiny config of ``tests/test_export.py:88-89`` (``n_pc`` 16,
batches 16/16, ``num_unlabel`` 64, 2 epochs) with noise and dropout off:

- the port's ``cli.export_model --train_bundle`` writes the bundle's
  files, and its signature (names, dtypes, shapes) is the JAX bundle's
  for the same flags, its schedule, pool and ``extra0`` files byte-equal
  to JAX's;
- the exported program (``.module()``, eager aten ops) equals the eager
  ``train_run`` from the same state, every output and metric bit for bit;
- fed the JAX bundle's own ``inputs/``, its outputs match the JAX
  program's by name within ``tests/test_full_run_torch_parity.py``'s
  tolerances (metrics rtol 5e-3 / atol 5e-4, params rtol 1e-2 /
  atol 1e-3): XLA and oneDNN sum in other orders;
- ``--import_run`` writes a checkpoint that restores equal to the run's
  outputs, and ``predict --checkpoint_dir`` maps from it.

The AOTInductor compile of a training program takes minutes on this CPU,
so the CLI's compile is replaced by a stand-in here that keeps the
program; the compiled package runs on the card (``chip_smoke.py``'s
``train_bundle`` phase), and the runner's N-ary mode is held on a small
program (``tests/test_torch_port_train_bundle_host.py``).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from cmlpl_tpu.data import SemiSupervisedSampler as JaxSampler
from cmlpl_tpu.data import generate_splits as jax_generate_splits
from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.data import synthetic_scene as jax_synthetic_scene
from cmlpl_tpu.train import CMLPLTrainer as JaxCMLPLTrainer
from cmlpl_tpu.train.state import CMLPLConfig as JaxConfig
from cmlpl_tpu.utils.export import build_run_exported as jax_build_run
from cmlpl_tpu.utils.export import save_run_bundle as jax_save_run_bundle
from cmlpl_tpu_torch.cli import export_model, predict
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.pipeline import SemiSupervisedSampler
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.data.splits import generate_splits
from cmlpl_tpu_torch.train import CMLPLTrainer
from cmlpl_tpu_torch.train.functional import StateLayout
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.utils.checkpoint import restore_checkpoint
from cmlpl_tpu_torch.utils.export import load_run_outputs

from torch_port_threads import one_torch_thread  # noqa: F401

TINY = dict(n_pc=16, labeled_batch=16, unlabeled_batch=16, num_epochs=2,
            num_unlabel=64, noise=0.0, dropout=0.0)
FLAGS = ["--dataID", "0", "--n_PC", "16", "--labeled_batch_size", "16",
         "--unlabeled_batch_size", "16", "--num_epochs", "2",
         "--num_unlabel", "64", "--noise", "0", "--dropout", "0",
         "--device", "cpu"]
SEED = 1088
# tests/test_full_run_torch_parity.py's tolerances
METRIC_TOL = dict(rtol=5e-3, atol=5e-4)
PARAM_TOL = dict(rtol=1e-2, atol=1e-3)
SCHEDULE = ("pool_idx", "lab_idx", "lab_y", "unl_idx", "extra0")


def read_inputs(directory, names):
    return [np.load(os.path.join(directory, "inputs", n + ".npy"))
            for n in names]


def as_torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """The port CLI's bundle (its compile replaced by a stand-in that keeps
    the exported program) and the JAX bundle of the same config, with the
    JAX program's outputs."""
    tmp = tmp_path_factory.mktemp("bundles")
    kept = {}

    def compile_stand_in(exported, package_path):
        kept["program"] = exported
        with open(package_path, "wb") as f:
            f.write(b"stand-in: compiled on the card")
        return package_path

    port_dir = str(tmp / "port")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch._inductor, "aoti_compile_and_package",
                       compile_stand_in)
            export_model.main(FLAGS + ["--train_bundle", port_dir])
    finally:
        os.chdir(cwd)

    cube, gt = jax_synthetic_scene(0)
    jscene = jax_prepare_scene(0, cube=cube, gt=gt, patch_size=20, n_pc=16)
    jsplits = jax_generate_splits(jscene.labels, num_label=5)
    jtrainer = JaxCMLPLTrainer(JaxConfig(**TINY))
    meta, exported, inputs = jax_build_run(
        jtrainer, jscene,
        JaxSampler(jsplits, jscene.labels, 16, 16, num_unlabel=64,
                   seed=SEED),
        jax.random.fold_in(jax.random.key(SEED), 0), platforms=["cpu"])
    jax_dir = str(tmp / "jax")
    jax_save_run_bundle(jax_dir, meta, exported, inputs)
    outs = jax.jit(exported.call)(*inputs.values())
    jax_out = {n: np.asarray(o) for n, o in zip(meta["output_names"], outs)}
    with open(os.path.join(port_dir, "meta.json")) as f:
        port_meta = json.load(f)
    return {"tmp": tmp, "port": port_dir, "meta": port_meta,
            "program": kept["program"].module(), "jax": jax_dir,
            "jax_meta": meta, "jax_out": jax_out}


@pytest.fixture(scope="module")
def port_run(bundles):
    """The port program's outputs on its own inputs, by name."""
    meta = bundles["meta"]
    outs = bundles["program"](*as_torch(read_inputs(bundles["port"],
                                                    meta["input_names"])))
    return {n: o.numpy() for n, o in zip(meta["output_names"], outs)}


def scene_and_sampler():
    cube, gt = synthetic_scene(0)
    scene = prepare_scene(0, cube=cube, gt=gt, patch_size=20, n_pc=16,
                          device="cpu")
    splits = generate_splits(scene.labels, num_label=5)
    return scene, SemiSupervisedSampler(splits, scene.labels, 16, 16,
                                        num_unlabel=64, seed=SEED)


def test_cli_writes_the_bundle(bundles):
    d, meta = bundles["port"], bundles["meta"]
    for name in ("model.pt2", "signature.txt", "meta.json"):
        assert os.path.isfile(os.path.join(d, name))
    assert sorted(os.listdir(os.path.join(d, "inputs"))) == sorted(
        n + ".npy" for n in meta["input_names"])
    for key in ("kind", "trainer", "num_epochs", "batches_per_epoch",
                "gather_impl", "input_names", "output_names", "platforms",
                "torch_version", "compute_dtype"):
        assert key in meta, key
    assert (meta["kind"], meta["trainer"], meta["platforms"]) == (
        "train_run", "CMLPLTrainer", ["cpu"])
    assert (meta["num_epochs"], meta["batches_per_epoch"],
            meta["gather_impl"], meta["seed"]) == (2, 4, "pool", SEED)


def test_signature_and_names_equal_jax(bundles):
    for key in ("input_names", "output_names"):
        assert bundles["meta"][key] == bundles["jax_meta"][key]
    with open(os.path.join(bundles["port"], "signature.txt")) as f:
        port = f.read().splitlines()
    with open(os.path.join(bundles["jax"], "signature.txt")) as f:
        jax_sig = f.read().splitlines()
    assert port == jax_sig


@pytest.mark.parametrize("name", SCHEDULE)
def test_schedule_files_byte_equal_jax(bundles, name):
    paths = [os.path.join(d, "inputs", name + ".npy")
             for d in (bundles["port"], bundles["jax"])]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def test_run_program_equals_eager_train_run(bundles, port_run):
    """Every output bit for bit: the state (flax layout) and the (E, N)
    metrics of the eager run from the bundle's initial state."""
    scene, sampler = scene_and_sampler()
    trainer = CMLPLTrainer(CMLPLConfig(**TINY), device="cpu")
    state, metrics = trainer.train_run(trainer.init_state((SEED, 0)), scene,
                                       sampler)
    rng = np.load(os.path.join(bundles["port"], "inputs", "state.rng.npy"))
    layout = StateLayout(trainer, state, rng)
    want = dict(zip(layout.names, layout.values))
    want.update({f"metrics.{k}": v.numpy() for k, v in metrics.items()})
    assert sorted(want) == sorted(port_run)
    for name, value in want.items():
        assert port_run[name].dtype == np.asarray(value).dtype, name
        np.testing.assert_array_equal(port_run[name], value, err_msg=name)
    assert int(port_run["state.step"]) == 8


def test_run_program_on_jax_inputs_matches_jax(bundles):
    jmeta = bundles["jax_meta"]
    outs = bundles["program"](*as_torch(read_inputs(bundles["jax"],
                                                    jmeta["input_names"])))
    for name, got in zip(jmeta["output_names"], outs):
        want = bundles["jax_out"][name]
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if name.startswith("metrics."):
            np.testing.assert_allclose(got, want, err_msg=name,
                                       **METRIC_TOL)
        elif got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, err_msg=name, **PARAM_TOL)
        elif name != "state.rng":
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_import_run_restores_and_maps(bundles, port_run):
    tmp = bundles["tmp"]
    outdir, ck = tmp / "out", tmp / "ck"
    outdir.mkdir()
    for name, value in port_run.items():
        np.save(outdir / (name + ".npy"), value)
    export_model.main(FLAGS + ["--import_run", bundles["port"], str(outdir),
                               "--checkpoint_dir", str(ck)])
    assert sorted(os.listdir(ck / "8")) == ["state.npz"]
    trainer = CMLPLTrainer(CMLPLConfig(**TINY), device="cpu")
    restored = restore_checkpoint(str(ck), trainer)
    layout = StateLayout(trainer, restored, port_run["state.rng"])
    for name, value in zip(layout.names, layout.values):
        np.testing.assert_array_equal(value, port_run[name], err_msg=name)
    state, metrics = load_run_outputs(bundles["port"], str(outdir), trainer)
    assert state.step == 8 and metrics["acc"].shape == (2, 4)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        pred = predict.main(["--dataID", "0", "--n_PC", "16",
                             "--checkpoint_dir", str(ck), "--device", "cpu",
                             "--out", str(tmp / "map.svg")])
    finally:
        os.chdir(cwd)
    assert pred.shape == (64 * 48,) and (pred >= 0).all() and (pred < 9).all()


@pytest.mark.parametrize("flags,match", [
    (["--fused_iters", "--num_iters", "2"], "--fused_iters"),
    (["--gather_impl", "xla"], "gathers its pool once"),
], ids=["fused_iters", "per_step_gather"])
def test_cli_refuses(tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        export_model.main(FLAGS + flags + ["--train_bundle",
                                           str(tmp_path / "b")])


def test_cli_cuda_bundle_needs_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this test holds the refusal where CUDA is absent")
    argv = [a for a in FLAGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_model.main(argv + ["--train_bundle", str(tmp_path / "b")])
    assert not (tmp_path / "b").exists()


def test_import_run_needs_a_checkpoint_dir(bundles):
    with pytest.raises(SystemExit, match="--checkpoint_dir"):
        export_model.main(FLAGS + ["--import_run", bundles["port"], "o"])
