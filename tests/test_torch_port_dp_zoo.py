"""The supervised trainer and the comparison zoo data parallel over two
gloo ranks on the CPU (``train/supervised.py`` with ``mesh=``,
``models/common.py``'s BatchNorm and dropout inside a sharded call,
``core/mesh.all_reduce_sum``), against the port's one-process step and
against the JAX package's ``SupervisedTrainer`` on a two-device mesh, and
the schedule's rounding to the ranks against JAX's.

Every case runs in one two-rank world (``torch_dist_worker.task_many``).

- Each of the nine ``ZOO`` entries at the small size of
  ``tests/test_torch_port_zoo.py`` (16 bands, 4 classes) on the 16x14
  scene of ``tests/test_torch_port_supervised.py``, batches of 6 (3 rows
  a rank), augmentations on, each model's dropout on, an EMA teacher:
  one step from ``init_state(0)`` against the one-process step, then the
  two replicas bitwise equal after 3 steps.  The ranks draw the whole
  batch's augmentations and dropout masks from copies of one generator,
  so the generators end bitwise the one-process run's; BatchNorm takes
  the global batch's mean and variance (two all-reduced passes, Σx then
  Σ(x - mean)^2, where one process takes ``torch.var_mean``).
- DBDA (5-D BatchNorms) and MSViT (4-D ones only), no dropout and no
  augmentation, 4 steps from the JAX trainer's initial state against
  ``SupervisedTrainer(mesh=create_mesh(jax.devices()[:2]))``.

Tolerances: those of ``tests/test_torch_port_supervised.py`` (losses
``LOSS_TOL``, params, statistics, Adam moments and the EMA teacher
``PARAM_TOL``), with its one exception widened to what forces it.  A
weight whose exact gradient is 0 gets rounding noise instead, and Adam,
which divides a gradient by its own RMS, steps it by up to lr either
way: a conv bias read only by train-mode BatchNorms (DBDA's, FDSSC's,
SSRN's, SSFTT's, MSViT's), and the key bias of SSFTT's attention (the
softmax over keys ignores a shift common to them).  Such an element,
one whose step-1 gradient lies below ``ROUNDING_ONLY`` of its model's
largest, is held to Adam's reach, 2 lr a step, and where a model has
one, its BatchNorms' running means (which those biases shift) to
(1 - 0.9) of that.  Measured on one step against one process: gradients
within 8e-7 of the model's largest, the losses within 2.4e-7.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from cmlpl_tpu.core.mesh import create_mesh as jax_create_mesh
from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.models.zoo import build_model as jax_build_model
from cmlpl_tpu.registry import get_dataset as jax_get_dataset
from cmlpl_tpu.train.supervised import SupervisedTrainer as JaxTrainer
from cmlpl_tpu_torch.core.mesh import Mesh
from cmlpl_tpu_torch.train import supervised
from cmlpl_tpu_torch.weights import (params_to_jax, save_params_npz,
                                     supervised_state_from_jax,
                                     supervised_state_to_jax)
from torch_dist_worker import (ZOO_BANDS, ZOO_CLASSES, ZOO_SHAPES,
                               run_ranks, task_zoo, zoo_cube, zoo_setup)
from torch_port_threads import one_torch_thread  # noqa: F401

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)
LR = 5e-4
ROUNDING_ONLY = 1e-4
MODELS = sorted(ZOO_SHAPES)
JAX_MODELS = ("dbda", "msvit")
JAX_STEPS = 4


@pytest.fixture(scope="module")
def mesh2():
    return jax_create_mesh(jax.devices()[:2])


@pytest.fixture(scope="module")
def jax_starts(mesh2, tmp_path_factory):
    """Per JAX model: its trainer on the two-device mesh, scene, initial
    state, the 4 batches of its schedule, and the files the ranks read."""
    tmp = tmp_path_factory.mktemp("zoo_jax")
    jspec = dataclasses.replace(jax_get_dataset(0), num_classes=ZOO_CLASSES,
                                num_bands=ZOO_BANDS)
    cube, gt = zoo_cube()
    out = {}
    for name in JAX_MODELS:
        w, n_pc = ZOO_SHAPES[name]
        model, entry = jax_build_model(name, jspec, n_pc)
        jt = JaxTrainer(model, entry, patch_size=w, n_pc=n_pc,
                        num_features=ZOO_BANDS, donate=False,
                        gather_impl="xla", mesh=mesh2)
        jscene = jax_prepare_scene(jspec, cube=cube, gt=gt, patch_size=w,
                                   n_pc=n_pc)
        jstate = jt.init_state(jax.random.key(1))
        port, scene, train = zoo_setup(name, None)
        li, ly = jt._schedule(train, scene.labels, 6, 2, None, 5)
        tree = supervised_state_to_jax(supervised_state_from_jax(
            jax.device_get(jstate), port))
        save_params_npz(str(tmp / f"{name}.npz"), tree)
        np.savez(tmp / f"{name}_batches.npz", li=li, ly=ly)
        out[name] = dict(jt=jt, jscene=jscene, jstate=jstate, li=li, ly=ly,
                         tree_npz=str(tmp / f"{name}.npz"),
                         batches_npz=str(tmp / f"{name}_batches.npz"))
    return out


@pytest.fixture(scope="module")
def two_ranks(jax_starts, tmp_path_factory):
    """Every case on the same two ranks (one world): the zoo's 3 steps by
    model, then the JAX models' 4 steps by model."""
    calls = [["zoo", dict(name=n)] for n in MODELS]
    calls += [["zoo_from_tree", dict(name=n, tree_npz=s["tree_npz"],
                                     batches_npz=s["batches_npz"],
                                     steps=JAX_STEPS)]
              for n, s in jax_starts.items()]
    ranks = run_ranks("many", str(tmp_path_factory.mktemp("zoo_ranks")),
                      calls=calls)
    results = [{c[1]["name"] + ("" if c[0] == "zoo" else "/jax"): r[k]
                for k, c in enumerate(calls)} for r in ranks]
    return results


@pytest.fixture(scope="module", params=MODELS)
def zoo(request, two_ranks):
    name = request.param
    return dict(name=name, ranks=[r[name] for r in two_ranks],
                one=task_zoo(None, name=name))


def _rounding_only(grads: dict) -> dict:
    """Each gradient's mask of elements below ROUNDING_ONLY of the
    model's largest gradient."""
    top = max(float(g.abs().max()) for g in grads.values())
    return {k: g.abs() < ROUNDING_ONLY * top for k, g in grads.items()}


def _assert_close(name, got, want, reach, noisy, noisy_model):
    """``got`` within PARAM_TOL of ``want``, the elements of ``noisy``
    within ``reach``; BN running means widened when the model has such
    elements."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = dict(PARAM_TOL)
    if noisy_model and name.endswith(("running_mean", "mean")):
        tol["atol"] += (1 - 0.9) * reach
    if noisy is not None and noisy.any():
        noisy = np.asarray(noisy)
        np.testing.assert_allclose(got[noisy], want[noisy], rtol=0,
                                   atol=reach, err_msg=name)
        got, want = got[~noisy], want[~noisy]
    np.testing.assert_allclose(got, want, err_msg=name, **tol)


def test_first_step_metrics_match_one_process(zoo):
    want = zoo["one"]["metrics"][0]
    for r in zoo["ranks"]:
        got = r["metrics"][0]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **LOSS_TOL)
        assert r["batch"] == 6


def test_first_step_gradients_are_the_global_gradient(zoo):
    """Summed over the ranks: each holds its rows' share, and the global
    batch's BatchNorm statistics carry the other rank's rows into it."""
    want = zoo["one"]["grads"]
    top = max(float(g.abs().max()) for g in want.values())
    for r in zoo["ranks"]:
        assert set(r["grads"]) == set(want)
        for k, g in want.items():
            assert float((r["grads"][k] - g).abs().max()) <= 1e-5 * top, k


def test_first_step_state_matches_one_process(zoo):
    """Params, BN running statistics, Adam moments and the EMA teacher
    after one step; the generator bitwise the one-process one's."""
    one = zoo["one"]
    noisy = _rounding_only(one["grads"])
    noisy_model = any(bool(m.any()) for m in noisy.values())
    want = one["after1"]
    for r in zoo["ranks"]:
        got = r["after1"]
        assert set(got) == set(want)
        assert torch.equal(got["generator"], want["generator"])
        for k, v in want.items():
            if k in ("generator", "step"):
                continue
            param = k.split("/", 1)[1]
            if k.startswith("opt/"):
                param = param.rsplit("/", 1)[0]
            mask = noisy.get(param) if k.startswith(("model/", "ema/")) \
                else None
            _assert_close(k, got[k], v, 2 * LR, mask, noisy_model)
        assert int(got["step"]) == 1


def test_ema_teacher_after_three_steps_matches_one_process(zoo):
    """The EMA teacher (params and BN statistics, replicated: each rank
    blends its own copy of the student) after 3 steps, against the
    one-process run's, the rounding-only elements at 3 steps' reach."""
    one = zoo["one"]
    noisy = _rounding_only(one["grads"])
    noisy_model = any(bool(m.any()) for m in noisy.values())
    ema = [k for k in one["final"] if k.startswith("ema/")]
    assert ema
    for r in zoo["ranks"]:
        for k in ema:
            _assert_close(k, r["final"][k], one["final"][k], 2 * LR * 3,
                          noisy.get(k.split("/", 1)[1]), noisy_model)
        assert any(not torch.equal(r["final"][k], r["after1"][k])
                   for k in ema)


def test_replicas_are_bitwise_equal_after_three_steps(zoo):
    """Params, BN statistics, EMA teacher, Adam moments and steps, the
    generator and the step: the same bits on both ranks, and the
    generator the one-process run's."""
    a, b = (r["final"] for r in zoo["ranks"])
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert int(a["step"]) == 3
    assert torch.equal(a["generator"], zoo["one"]["final"]["generator"])


# -- against JAX's two-device mesh ------------------------------------------ #
@pytest.fixture(scope="module", params=JAX_MODELS)
def parity(request, jax_starts, two_ranks):
    name = request.param
    s = jax_starts[name]
    jstate, jms = s["jstate"], []
    for i in range(JAX_STEPS):
        jstate, jm = s["jt"].train_step(jstate, s["jscene"], s["li"][i],
                                        s["ly"][i])
        jms.append({k: float(v) for k, v in jm.items()})
    return dict(name=name, ranks=[r[f"{name}/jax"] for r in two_ranks],
                jms=jms, jstate=jax.device_get(jstate))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def test_two_rank_metrics_match_the_jax_mesh_step(parity):
    for r in parity["ranks"]:
        assert len(r["metrics"]) == len(parity["jms"]) == JAX_STEPS
        for i, (jm, m) in enumerate(zip(parity["jms"], r["metrics"])):
            assert set(m) == set(jm)
            for k in jm:
                np.testing.assert_allclose(m[k], jm[k],
                                           err_msg=f"step {i} {k}",
                                           **LOSS_TOL)


def test_two_rank_state_matches_the_jax_mesh_state(parity):
    """Params, BN running statistics and Adam moments after 4 steps."""
    js = parity["jstate"]
    reach = 2 * LR * JAX_STEPS
    adam = js.opt_state[0]
    for r in parity["ranks"]:
        tree = r["tree"]
        noisy = dict(_leaves(params_to_jax({
            k: m for k, m in _rounding_only(r["grads"]).items()})))
        noisy_model = any(m.any() for m in noisy.values())
        pairs = [("params", tree["params"], js.params, True),
                 ("stats", tree["batch_stats"], js.batch_stats, False),
                 ("mu", tree["opt_state"]["0"]["mu"], adam.mu, False),
                 ("nu", tree["opt_state"]["0"]["nu"], adam.nu, False)]
        for part, mine, theirs, held in pairs:
            want = dict(jax.tree_util.tree_leaves_with_path(theirs))
            got = dict(_leaves(mine))
            assert len(got) == len(want) > 0, part
            for path, w_ in want.items():
                key = "".join(f"/{getattr(p, 'key', p)}" for p in path)
                mask = noisy.get(key) if held else None
                _assert_close(f"{part}{key}", got[key], w_, reach,
                              None if mask is None else mask.astype(bool),
                              noisy_model)
        assert int(tree["step"]) == int(js.step) == JAX_STEPS
        assert int(tree["opt_state"]["0"]["count"]) == int(adam.count)


# -- the schedule's rounding, no processes ----------------------------------- #
@functools.lru_cache(maxsize=None)
def _schedule_trainers(devices: int):
    """JAX's trainer over a mesh of ``devices`` and the port's over as
    many ranks (a ``Mesh`` with no process group: nothing is
    communicated, the rounding reads its size)."""
    jspec = dataclasses.replace(jax_get_dataset(0), num_classes=ZOO_CLASSES,
                                num_bands=ZOO_BANDS)
    model, entry = jax_build_model("basenet2", jspec, 6)
    jt = JaxTrainer(model, entry, patch_size=8, n_pc=6,
                    num_features=ZOO_BANDS, donate=False,
                    mesh=jax_create_mesh(jax.devices()[:devices]))
    trainer = supervised.SupervisedTrainer(
        "basenet2", jspec, patch_size=8, n_pc=6, device="cpu",
        mesh=Mesh(0, devices, torch.device("cpu")))
    return jt, trainer


@pytest.mark.parametrize("devices", [1, 2, 3, 8])
@pytest.mark.parametrize("n,batch,epochs,samples", [
    (12, 6, 3, None), (45, 128, 3, None), (45, 7, 2, None),
    (12, 5, 2, 40), (45, 128, 2, 1280), (5, 128, 2, None)])
def test_schedule_rounds_the_batch_to_the_ranks_as_jax(devices, n, batch,
                                                      epochs, samples):
    """``_schedule`` and ``steps_per_epoch`` of a trainer over ``devices``
    ranks equal the JAX trainer's over a mesh of as many devices (45
    labels on 2 ranks: batches of 44; 5 labels on 8: the split tiled to
    8)."""
    jt, trainer = _schedule_trainers(devices)
    rng = np.random.default_rng(n + devices)
    idx = rng.choice(200, size=n, replace=False)
    labels = rng.integers(1, 10, size=200)
    got = trainer._schedule(idx, labels, batch, epochs, samples, 7)
    want = jt._schedule(idx, labels, batch, epochs, samples, 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape[1] % devices == 0
    assert (trainer.steps_per_epoch(n, batch, samples)
            == supervised.steps_per_epoch(n, batch, samples, devices)
            == jt.steps_per_epoch(n, batch, samples)
            == got[0].shape[0] // epochs)
