"""The training-run bundle's program for CPS, CCT and bf16 CMLPL, and its
draws (``cmlpl_tpu_torch/utils/export.build_run_exported``), at the tiny
config of ``tests/test_export.py:88-89``.

- With noise and dropout off, the exported program (``.module()``)
  equals the eager ``train_run`` from the same state bit for bit: CPS,
  CCT (two Adams overlapping in the encoder) and CMLPL under
  ``compute_dtype="bfloat16"``, as f32 CMLPL
  (``tests/test_torch_port_train_bundle.py``).
- With noise and dropout on, the program's draws come from ``state.rng``
  and ``state.step`` alone: it equals its own step run eagerly in a
  Python loop (``RunStep`` over the same inputs) bit for bit, and another
  key gives another run.
"""

import numpy as np
import pytest
import torch

from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.patches import gather_patches, gather_spectra
from cmlpl_tpu_torch.data.pipeline import SemiSupervisedSampler
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.data.splits import generate_splits
from cmlpl_tpu_torch.train import CCTTrainer, CMLPLTrainer, CPSTrainer
from cmlpl_tpu_torch.train.functional import RunStep, StateLayout
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.utils.export import build_run_exported

from torch_port_threads import one_torch_thread  # noqa: F401

TINY = dict(n_pc=16, labeled_batch=16, unlabeled_batch=16, num_epochs=2,
            num_unlabel=64)
SEED = 1088


@pytest.fixture(scope="module")
def scene():
    cube, gt = synthetic_scene(0)
    return prepare_scene(0, cube=cube, gt=gt, patch_size=20, n_pc=16,
                         device="cpu")


def sampler(scene):
    splits = generate_splits(scene.labels, num_label=5)
    return SemiSupervisedSampler(splits, scene.labels, 16, 16,
                                 num_unlabel=64, seed=SEED)


def program_and_eager(trainer, scene):
    """(the program's outputs on its inputs, the eager run's) by name."""
    meta, exported, inputs = build_run_exported(trainer, scene,
                                                sampler(scene), (SEED, 0))
    outs = exported.module()(*[torch.from_numpy(np.array(v))
                               for v in inputs.values()])
    got = {n: o.numpy() for n, o in zip(meta["output_names"], outs)}
    state, metrics = trainer.train_run(trainer.init_state((SEED, 0)),
                                       scene, sampler(scene))
    layout = StateLayout(trainer, state, inputs["state.rng"])
    want = dict(zip(layout.names, layout.values))
    want.update({f"metrics.{k}": v.float().numpy()
                 for k, v in metrics.items()})
    assert sorted(got) == sorted(want)
    return got, want


@pytest.mark.parametrize("trainer_cls,dtype", [
    (CPSTrainer, "float32"), (CCTTrainer, "float32"),
    (CMLPLTrainer, "bfloat16")], ids=["cps", "cct", "cmlpl_bf16"])
def test_run_program_equals_eager(scene, trainer_cls, dtype):
    trainer = trainer_cls(CMLPLConfig(noise=0.0, dropout=0.0,
                                      compute_dtype=dtype, **TINY),
                          device="cpu")
    got, want = program_and_eager(trainer, scene)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_draws_come_from_the_key_and_step(scene):
    """Noise and dropout on: the program equals its step looped eagerly,
    bit for bit, and another ``state.rng`` trains otherwise."""
    trainer = CMLPLTrainer(CMLPLConfig(dropout=0.5, **TINY), device="cpu")
    meta, exported, inputs = build_run_exported(trainer, scene,
                                                sampler(scene), (SEED, 0))
    args = [torch.from_numpy(np.array(v)) for v in inputs.values()]
    program = exported.module()
    outs = program(*args)

    state = trainer.init_state((SEED, 0))
    layout = StateLayout(trainer, state, inputs["state.rng"])
    step = RunStep(trainer, state, layout)
    n = len(layout.leaves)
    tensors = layout.to_torch(args[:n])
    padded, spectra, pool, li, ly, ui, thr = args[n:]
    xp_src = gather_patches(padded, pool, cols=scene.cols, w=20)
    x_src = gather_spectra(spectra, pool)
    metrics = []
    e, b = li.shape[:2]
    for i in range(e * b):
        ep, bi = divmod(i, b)
        tensors, m = step(tensors, xp_src, x_src, li[ep, bi], ly[ep, bi],
                          ui[ep, bi], torch.tensor(ep), torch.tensor(bi),
                          thr[ep])
        metrics.append(m)
    want = layout.to_jax(tensors)
    for name, got, value in zip(meta["output_names"], outs, want):
        assert torch.equal(got, value), name
    loss = torch.stack([m["total_loss"] for m in metrics]).reshape(e, b)
    names = meta["output_names"]
    assert torch.equal(outs[names.index("metrics.total_loss")], loss)

    other = list(args)
    other[meta["input_names"].index("state.rng")] = torch.tensor(
        [1, 2], dtype=torch.uint32)
    outs2 = program(*other)
    at = names.index("metrics.total_loss")
    assert not torch.equal(outs2[at][0, 0], outs[at][0, 0])
    assert not torch.equal(outs2[names.index(
        "state.net_b.params.conv1.kernel")], outs[names.index(
            "state.net_b.params.conv1.kernel")])
