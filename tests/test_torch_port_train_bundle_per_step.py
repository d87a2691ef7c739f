"""The training-run bundle with a per-step gather
(``cmlpl_tpu_torch/utils/export.build_run_exported`` under
``gather_impl`` "xla", "pallas" and "pallas_bf16";
``cli.export_model --train_bundle --gather_impl``) against the eager
trainers and the JAX package's non-pool bundle
(``cmlpl_tpu/utils/export.py:183-260``, whose ``run_fn`` gathers each
step's patches inside the program, ``cmlpl_tpu/train/cmlpl.py:529-545``),
and the gather operators that such a program holds
(``cmlpl::gather_patches_f32`` and ``_bf16``, ``ops/patch_gather.py``,
``csrc/gather_ops.cpp``).

At a tiny config (``n_pc`` 16, batches 16/16, ``num_unlabel`` 48: one
epoch of 3 steps) with noise and dropout off:

- (a) each mode's program (``.module()``) equals its own step
  (``RunStep``) looped eagerly and the eager ``train_run`` of that mode,
  every output bit for bit: CMLPL in the three modes, CPS and CCT under
  "xla";
- (b) fed the JAX "xla" bundle's own inputs, the port's "xla" program
  matches the JAX program by name within
  ``tests/test_full_run_torch_parity.py``'s bounds;
- (c) the CLI's per-step bundle has the JAX non-pool bundle's input and
  output names and signature, and its schedule files are byte-equal;
- (d) the operators: their fake kernel, their CPU kernel (the plain
  gather, bit for bit), ``torch.library.opcheck``; a kernel mode's graph
  holds its operator, two nodes a step, and calls nothing else of the
  port; a ``cpu`` bundle of a kernel mode is refused by name;
- (e) the C++ registration's schemas are the Python ones, and the C++
  launch plan (``csrc/gather_plan.h``) is ``gather_plan`` at every shape
  swept.

No AOTInductor compile: the CLI's is replaced by a stand-in that keeps
the program.  The compiled package runs on the card (``chip_smoke.py``'s
``train_bundle_per_step`` phase).
"""

import ctypes
import json
import os
import re
import subprocess

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
from cmlpl_tpu_torch.cli import export_model
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.patches import gather_patches
from cmlpl_tpu_torch.data.pipeline import SemiSupervisedSampler
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.data.splits import generate_splits
from cmlpl_tpu_torch.ops.patch_gather import OP_SCHEMAS, gather_plan
from cmlpl_tpu_torch.train import CCTTrainer, CMLPLTrainer, CPSTrainer
from cmlpl_tpu_torch.train.functional import RunStep, StateLayout
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.utils.export import (RUN_INPUTS_PER_STEP,
                                          save_run_bundle)

from torch_port_threads import one_torch_thread  # noqa: F401

TINY = dict(n_pc=16, labeled_batch=16, unlabeled_batch=16, num_epochs=1,
            num_unlabel=48, noise=0.0, dropout=0.0)
FLAGS = ["--dataID", "0", "--n_PC", "16", "--labeled_batch_size", "16",
         "--unlabeled_batch_size", "16", "--num_epochs", "1",
         "--num_unlabel", "48", "--noise", "0", "--dropout", "0",
         "--device", "cpu", "--gather_impl", "xla"]
SEED = 1088
STEPS = 3
# tests/test_full_run_torch_parity.py's tolerances
METRIC_TOL = dict(rtol=5e-3, atol=5e-4)
PARAM_TOL = dict(rtol=1e-2, atol=1e-3)
SCHEDULE = ("lab_idx", "lab_y", "unl_idx", "extra0")
CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cmlpl_tpu_torch", "csrc")
OPS = {"pallas": "cmlpl::gather_patches_f32",
       "pallas_bf16": "cmlpl::gather_patches_bf16"}

CASES = {"cmlpl_xla": (CMLPLTrainer, "xla"),
         "cmlpl_pallas": (CMLPLTrainer, "pallas"),
         "cmlpl_pallas_bf16": (CMLPLTrainer, "pallas_bf16"),
         "cps_xla": (CPSTrainer, "xla"),
         "cct_xla": (CCTTrainer, "xla")}


@pytest.fixture(scope="module")
def scene():
    cube, gt = synthetic_scene(0)
    return prepare_scene(0, cube=cube, gt=gt, patch_size=20, n_pc=16,
                         device="cpu")


def sampler(scene):
    splits = generate_splits(scene.labels, num_label=5)
    return SemiSupervisedSampler(splits, scene.labels, 16, 16,
                                 num_unlabel=48, seed=SEED)


def trainer_of(case):
    cls, mode = CASES[case]
    return cls(CMLPLConfig(gather_impl=mode, **TINY), device="cpu")


@pytest.fixture(scope="module")
def cli_bundle(tmp_path_factory):
    """``cli.export_model --train_bundle --gather_impl xla``, its compile
    replaced by a stand-in that keeps the program."""
    tmp = tmp_path_factory.mktemp("per_step")
    kept = {}

    def compile_stand_in(exported, package_path):
        kept["program"] = exported
        with open(package_path, "wb") as f:
            f.write(b"stand-in: compiled on the card")
        return package_path

    bundle = str(tmp / "port")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch._inductor, "aoti_compile_and_package",
                       compile_stand_in)
            export_model.main(FLAGS + ["--train_bundle", bundle])
    finally:
        os.chdir(cwd)
    with open(os.path.join(bundle, "meta.json")) as f:
        meta = json.load(f)
    inputs = {n: np.load(os.path.join(bundle, "inputs", n + ".npy"))
              for n in meta["input_names"]}
    return {"tmp": tmp, "dir": bundle, "meta": meta, "inputs": inputs,
            "exported": kept["program"]}


@pytest.fixture(scope="module")
def programs(scene, cli_bundle):
    """Each case's (meta, exported program, inputs), built once; CMLPL
    under "xla" is the CLI's."""
    from cmlpl_tpu_torch.utils.export import build_run_exported

    cache = {"cmlpl_xla": (cli_bundle["meta"], cli_bundle["exported"],
                           cli_bundle["inputs"])}

    def get(case):
        if case not in cache:
            cache[case] = build_run_exported(trainer_of(case), scene,
                                             sampler(scene), (SEED, 0))
        return cache[case]

    return get


@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    """The JAX package's "xla" (non-pool) bundle of the same config, and
    its program's outputs."""
    cube, gt = jax_synthetic_scene(0)
    jscene = jax_prepare_scene(0, cube=cube, gt=gt, patch_size=20, n_pc=16)
    jsplits = jax_generate_splits(jscene.labels, num_label=5)
    trainer = JaxCMLPLTrainer(JaxConfig(gather_impl="xla", **TINY))
    meta, exported, inputs = jax_build_run(
        trainer, jscene,
        JaxSampler(jsplits, jscene.labels, 16, 16, num_unlabel=48,
                   seed=SEED),
        jax.random.fold_in(jax.random.key(SEED), 0), platforms=["cpu"])
    directory = str(tmp_path_factory.mktemp("jax") / "bundle")
    jax_save_run_bundle(directory, meta, exported, inputs)
    outs = jax.jit(exported.call)(*inputs.values())
    return {"dir": directory, "meta": meta, "inputs": inputs,
            "out": {n: np.asarray(o)
                    for n, o in zip(meta["output_names"], outs)}}


def as_torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------------------------------------------- (a)

@pytest.mark.parametrize("case", list(CASES))
def test_program_equals_its_step_and_the_eager_run(scene, programs, case):
    meta, exported, inputs = programs(case)
    trainer = trainer_of(case)
    args = as_torch(inputs.values())
    got = dict(zip(meta["output_names"], exported.module()(*args)))
    assert meta["gather_impl"] == CASES[case][1]
    assert meta["custom_ops"] == ([OPS[CASES[case][1]]]
                                  if CASES[case][1] in OPS else [])
    extras = ["extra0"] if CASES[case][0] is CMLPLTrainer else []
    assert [n for n in inputs if not n.startswith("state.")] == [
        *RUN_INPUTS_PER_STEP, *extras]

    # its own step, looped eagerly over the program's inputs
    state = trainer.init_state((SEED, 0))
    layout = StateLayout(trainer, state, inputs["state.rng"])
    step = RunStep(trainer, state, layout, cols=scene.cols)
    n = len(layout.leaves)
    tensors = layout.to_torch(args[:n])
    padded, spectra, li, ly, ui, *extra = args[n:]
    xp_src, x_src = trainer._prep_cube(padded), trainer.cast(spectra)
    history = []
    for i in range(li.shape[1]):
        tensors, m = step(tensors, xp_src, x_src, li[0, i], ly[0, i],
                          ui[0, i], torch.tensor(0), torch.tensor(i),
                          extra[0][0] if extra else None)
        history.append(m)
    looped = dict(zip(layout.names, layout.to_jax(tensors)))
    looped.update({f"metrics.{k}": torch.stack([h[k] for h in history])
                   .reshape(1, -1) for k in history[0]})
    assert sorted(looped) == sorted(got)
    for name, value in looped.items():
        assert torch.equal(got[name], value), name

    # the eager trainer's run of the same mode
    state, metrics = trainer.train_run(trainer.init_state((SEED, 0)), scene,
                                       sampler(scene))
    eager = StateLayout(trainer, state, inputs["state.rng"])
    want = dict(zip(eager.names, eager.values))
    want.update({f"metrics.{k}": v.float().numpy()
                 for k, v in metrics.items()})
    assert int(got["state.step"]) == STEPS
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value,
                                      err_msg=name)


# ------------------------------------------------------------------- (b)

def test_xla_program_on_jax_inputs_matches_jax(programs, jax_bundle):
    meta, exported, _ = programs("cmlpl_xla")
    jmeta = jax_bundle["meta"]
    assert jmeta["input_names"] == meta["input_names"]
    outs = exported.module()(*as_torch(jax_bundle["inputs"].values()))
    for name, got in zip(jmeta["output_names"], outs):
        want = jax_bundle["out"][name]
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if name.startswith("metrics."):
            np.testing.assert_allclose(got, want, err_msg=name,
                                       **METRIC_TOL)
        elif got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, err_msg=name, **PARAM_TOL)
        elif name != "state.rng":
            np.testing.assert_array_equal(got, want, err_msg=name)


# ------------------------------------------------------------------- (c)

def test_cli_bundle_names_and_signature_equal_jax(cli_bundle, jax_bundle):
    meta = cli_bundle["meta"]
    assert (meta["gather_impl"], meta["custom_ops"]) == ("xla", [])
    assert "pool_idx" not in meta["input_names"]
    for key in ("input_names", "output_names"):
        assert meta[key] == jax_bundle["meta"][key], key
    signatures = []
    for d in (cli_bundle["dir"], jax_bundle["dir"]):
        with open(os.path.join(d, "signature.txt")) as f:
            signatures.append(f.read().splitlines())
    assert signatures[0] == signatures[1]


@pytest.mark.parametrize("name", SCHEDULE)
def test_schedule_files_byte_equal_jax(cli_bundle, jax_bundle, name):
    paths = [os.path.join(d, "inputs", name + ".npy")
             for d in (cli_bundle["dir"], jax_bundle["dir"])]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


# ------------------------------------------------------------------- (d)

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_operator_cpu_kernel_fake_and_opcheck(dtype):
    g = torch.Generator().manual_seed(0)
    cube = torch.randn(31, 29, 7, generator=g).to(dtype)
    idx = torch.randint(-40, 31 * 12, (9,), generator=g, dtype=torch.int32)
    op = {torch.float32: torch.ops.cmlpl.gather_patches_f32,
          torch.bfloat16: torch.ops.cmlpl.gather_patches_bf16}[dtype].default
    out = op(cube, idx, 12, 6)
    assert torch.equal(out, gather_patches(cube, idx, cols=12, w=6))
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = op(mode.from_tensor(cube), mode.from_tensor(idx), 12, 6)
    assert (fake.shape, fake.dtype) == (out.shape, out.dtype)
    torch.library.opcheck(op, (cube, idx, 12, 6))
    with pytest.raises(TypeError, match="cube must be"):
        op(cube.float() if dtype == torch.bfloat16 else cube.bfloat16(),
           idx, 12, 6)


@pytest.mark.parametrize("case", ["cmlpl_pallas", "cmlpl_pallas_bf16"])
def test_kernel_graph_holds_two_operator_nodes_a_step(programs, case):
    meta, exported, _ = programs(case)
    op = OPS[CASES[case][1]]
    graphs = [m for m in exported.graph_module.modules()
              if isinstance(m, torch.fx.GraphModule)]
    body = [g for g in graphs if any(
        isinstance(n.target, torch._ops.OpOverload)
        and n.target._schema.name == op for n in g.graph.nodes)]
    assert len(body) == 1 and body[0] is not exported.graph_module
    for g in graphs:
        for node in g.graph.nodes:
            if node.op != "call_function":
                continue
            target = node.target
            # aten and loop operators and getitem, never a Python call
            # into the port (the ctypes launch stays behind the operator)
            assert isinstance(target, (torch._ops.OpOverload,
                                       torch._ops.HigherOrderOperator)) \
                or getattr(target, "__module__", "") == "_operator", target
    nodes = [n for n in body[0].graph.nodes
             if isinstance(n.target, torch._ops.OpOverload)
             and n.target._schema.name == op]
    assert len(nodes) == 2            # the labeled and unlabeled patches


def test_cpu_bundle_of_a_kernel_mode_is_refused(programs, tmp_path):
    meta, exported, inputs = programs("cmlpl_pallas")
    assert meta["platforms"] == ["cpu"]
    with pytest.raises(ValueError, match="cmlpl::gather_patches_f32.*cuda"):
        save_run_bundle(str(tmp_path / "b"), meta, exported, inputs)
    assert not (tmp_path / "b").exists()


# ------------------------------------------------------------------- (e)

def test_cxx_schemas_are_the_python_ones():
    with open(os.path.join(CSRC, "gather_ops.cpp")) as f:
        defs = re.findall(r'm\.def\("([^"]+)"\)', f.read())
    assert sorted(defs) == sorted(OP_SCHEMAS.values())
    for name, schema in OP_SCHEMAS.items():
        got = str(getattr(torch.ops.cmlpl, name).default._schema)
        assert got == "cmlpl::" + schema


PLAN_SHIM = r"""
#include "gather_plan.h"
extern "C" void plan(long long b, long long w, long long c, long long e,
                     long long sms, long long* out) {
  cmlpl::GatherPlan p = cmlpl::PlanGather(b, w, c, e, sms);
  out[0] = p.path; out[1] = p.group; out[2] = p.rows_per_warp;
  out[3] = p.grid;
}
"""


def test_cxx_plan_is_gather_plan(tmp_path):
    src, lib = tmp_path / "shim.cpp", tmp_path / "shim.so"
    src.write_text(PLAN_SHIM)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                    CSRC, str(src), "-o", str(lib)], check=True)
    fn = ctypes.CDLL(str(lib)).plan
    fn.argtypes = [ctypes.c_longlong] * 5 + [ctypes.POINTER(
        ctypes.c_longlong)]
    out = (ctypes.c_longlong * 4)()
    swept = 0
    for b in (1, 7, 45, 128, 512, 10240, 40960):
        for w in (5, 7, 8, 9, 13, 20, 33):
            for c in (1, 5, 30, 60, 103):
                for e in (2, 4):
                    fn(b, w, c, e, 132, out)
                    assert tuple(out) == tuple(gather_plan(b, w, c, e,
                                                           132)), \
                        (b, w, c, e)
                    swept += 1
    fn(0, 20, 60, 4, 132, out)
    assert out[0] == -1            # where gather_plan raises
    assert swept == 7 * 7 * 5 * 2
