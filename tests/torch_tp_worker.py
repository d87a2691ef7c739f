"""One rank of the port's tensor-parallel tests (``test_torch_port_tp_*``).

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_tp_worker.py <task> <out_dir> [json kwargs]

is ``tests/torch_dist_worker.py``'s command line with the tasks below,
which run on the ("data", "model") mesh of ``create_mesh_2d(tp)`` (made
once a tp in a rank's process).  Each task also runs with ``mesh=None``
in the test's own process: the one-process reference.  A state comes
back as its whole JAX-layout tree (``state_to_jax``, gathered over the
model ranks) and, under ``"local"``, as the rank's own shards in that
layout.  :func:`run_ranks` starts the ranks; nothing here imports JAX.
"""

from __future__ import annotations

import copy
import os
import sys
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch_dist_worker as dw  # noqa: E402
from cmlpl_tpu_torch import weights  # noqa: E402
from cmlpl_tpu_torch.core.mesh import (assert_tp_placed,  # noqa: E402
                                       barrier, create_mesh_2d,
                                       tp_gather_tree, tp_of)
from cmlpl_tpu_torch.core.mesh import TP_COLLECTIVES  # noqa: E402
from cmlpl_tpu_torch.train.state import CMLPLConfig  # noqa: E402

_MESHES: dict = {}


def mesh_2d(mesh, tp: int):
    """The world's ("data", "model") mesh at ``tp``, or None for the
    one-process reference (``mesh`` None)."""
    if mesh is None:
        return None
    if tp not in _MESHES:
        _MESHES[tp] = create_mesh_2d(tp, "cpu")
    return _MESHES[tp]


def leaves(tree, prefix=""):
    """(path, array) of each leaf of a nested dict, paths ``/``-joined."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, np.asarray(tree)


def tree_path(path) -> str:
    """A JAX key path (``tree_leaves_with_path``) as the port's tree
    path: fields, dict keys and tuple indices joined by ``/``."""
    out = []
    for p in path:
        for attr in ("name", "key", "idx"):
            if hasattr(p, attr):
                out.append(str(getattr(p, attr)))
                break
    return "/".join(out)


def local_tree(trainer, state) -> dict:
    """The state's JAX-layout tree as this rank holds it: its shards, not
    gathered."""
    with mock.patch.object(weights, "tp_gather_tree",
                           lambda tree, mesh, prefix="": tree):
        return trainer.state_to_jax(state)


def grads_tree(modules: dict) -> dict:
    """The modules' gradients as whole JAX-layout trees, by module."""
    return {name: tp_gather_tree(weights.params_to_jax(
        {n: p.grad for n, p in mod.named_parameters()
         if p.grad is not None}), tp_of(mod))
        for name, mod in modules.items()}


def _placed(modules) -> bool:
    for mod in modules:
        tp = tp_of(mod)
        if tp is None:
            return False
        assert_tp_placed(mod, tp)
    return True


def task_coords(mesh, tps=(2, 4)):
    """This rank's (data, model) and the axes' sizes at each tp; the
    refusals' messages."""
    out = {}
    for tp in tps:
        m = mesh_2d(mesh, tp)
        out[tp] = (m.data, m.model, m.data_size, m.tp, m.rows(8),
                   m.cols(1024))
    for tp in (0, 3, 8):
        try:
            create_mesh_2d(tp, "cpu")
        except ValueError as e:
            out[f"refused{tp}"] = str(e)
    one = create_mesh_2d(1, "cpu")
    out["tp1"] = (one.tp, one.data_size, one.data_group, one.model_group)
    return out


def task_grads(mesh, tp=2):
    """``all_reduce_grads`` on the mesh of a CMLPL state whose every
    gradient holds ``rank + 1``: each parameter's gradient value after
    it, by name."""
    from cmlpl_tpu_torch.core.mesh import all_reduce_grads

    m = mesh_2d(mesh, tp)
    trainer = dw.TRAINERS["cmlpl"](CMLPLConfig(**dw.TINY), device="cpu",
                                   mesh=m)
    state = trainer.init_state(0)
    named = trainer.named_params(state)
    for p in named.values():
        p.grad = torch.full_like(p, float(m.rank + 1))
    all_reduce_grads(named.values(), m)
    return {n: sorted(set(p.grad.reshape(-1).tolist()))
            for n, p in named.items()}


def task_layout(mesh, tp, trees):
    """For each ``(kind, tree_npz)`` of ``trees`` (kind: a trainer of
    ``torch_dist_worker.TRAINERS`` or a zoo model), the state of the whole
    tree built on the mesh: its local tree, its whole one and whether
    ``feat_spe`` is placed."""
    from cmlpl_tpu_torch.weights import StateTree, load_params_npz

    m = mesh_2d(mesh, tp)
    out = {}
    for kind, path in trees:
        if kind in dw.TRAINERS:
            trainer = dw.TRAINERS[kind](CMLPLConfig(**dw.TINY),
                                        device="cpu", mesh=m)
        else:
            trainer = dw.zoo_setup(kind, m, ema_alpha=0.9)[0]
        state = trainer.state_from_jax(StateTree(load_params_npz(path)))
        mods = (list(trainer._modules(state).values())
                if kind in dw.TRAINERS else [state.model, state.ema])
        out[kind] = {"local": local_tree(trainer, state),
                     "whole": trainer.state_to_jax(state),
                     "placed": _placed(mods)}
    return out


def task_from_tree(mesh, tp, algo, tree_npz, batches_npz, steps):
    """Noise-off steps of ``algo`` from a JAX-layout state on the batches
    of ``batches_npz`` (``torch_dist_worker.task_from_tree``'s), on the
    mesh: the metrics, the whole final tree and the local one."""
    from cmlpl_tpu_torch.weights import StateTree, load_params_npz

    m = mesh_2d(mesh, tp)
    scene, _ = dw.tiny_scene()
    cfg = CMLPLConfig(**dict(dw.TINY, noise=0.0, dropout=0.0),
                      gather_impl="pool")
    trainer = dw.TRAINERS[algo](cfg, device="cpu", mesh=m)
    state = trainer.place(trainer.state_from_jax(
        StateTree(load_params_npz(tree_npz))))
    b = np.load(batches_npz)
    metrics = []
    for i in range(steps):
        state, mt = trainer.train_step(
            state, scene, b["li"][i], b["ly"][i], b["ui"][i],
            epoch=int(b["epoch"][i]), batch_index=int(b["bi"][i]))
        metrics.append({k: float(v) for k, v in mt.items()})
    return {"metrics": metrics, "tree": trainer.state_to_jax(state),
            "local": local_tree(trainer, state)}


def task_steps(mesh, tp=2, algo="cmlpl", extra_loss="",
               compute_dtype="float32", noise=0.5, dropout=0.5, steps=3):
    """``steps`` steps of ``algo`` from ``init_state(0)`` on the tiny scene
    (``torch_dist_worker.task_steps``'s): each step's metrics, the step-1
    gradients (whole), the whole tree after step 1 and after the last,
    the local tree after the last, the generator's state, whether
    ``feat_spe`` is split, and the model axis's all-reduces in step 1."""
    m = mesh_2d(mesh, tp)
    scene, splits = dw.tiny_scene()
    cfg = CMLPLConfig(**dict(dw.TINY, noise=noise, dropout=dropout),
                      extra_loss=extra_loss, compute_dtype=compute_dtype)
    trainer = dw.TRAINERS[algo](cfg, device="cpu", mesh=m)
    state = trainer.init_state(0)
    out = {"metrics": []}
    for i, ((epoch, bi), (li, ly, ui)) in enumerate(
            zip(dw.STEPS[:steps], dw.batches(scene, splits, steps))):
        TP_COLLECTIVES.reset()
        state, mt = trainer.train_step(state, scene, li, ly, ui,
                                       epoch=epoch, batch_index=bi)
        out["metrics"].append({k: float(v) for k, v in mt.items()})
        if i == 0:
            out["tp_calls"] = TP_COLLECTIVES.calls
            out["grads"] = grads_tree(trainer._modules(state))
            # a copy: a tree's arrays may share the state's CPU memory
            out["after1"] = copy.deepcopy(trainer.state_to_jax(state))
    out["final"] = trainer.state_to_jax(state)
    out["local"] = local_tree(trainer, state)
    out["generator"] = state.generator.get_state()
    out["placed"] = _placed(trainer._modules(state).values())
    return out


def task_zoo(mesh, tp=2, name="basenet2", steps=3, augment=True,
             ema_alpha=0.9):
    """``steps`` supervised steps of zoo model ``name`` from
    ``init_state(0)`` (``torch_dist_worker.task_zoo``'s): as
    :func:`task_steps`, the EMA teacher in the trees."""
    m = mesh_2d(mesh, tp)
    trainer, scene, train = dw.zoo_setup(name, m, augment=augment,
                                         ema_alpha=ema_alpha)
    state = trainer.init_state(0)
    li, ly = trainer._schedule(train, scene.labels, dw.ZOO_BATCH, 2, None,
                               3)
    out = {"metrics": [], "batch": li.shape[1]}
    for i in range(steps):
        state, mt = trainer.train_step(state, scene, li[i], ly[i])
        out["metrics"].append({k: float(v) for k, v in mt.items()})
        if i == 0:
            out["grads"] = grads_tree({"model": state.model})
            # a copy: a tree's arrays may share the state's CPU memory
            out["after1"] = copy.deepcopy(trainer.state_to_jax(state))
    out["final"] = trainer.state_to_jax(state)
    out["local"] = local_tree(trainer, state)
    out["generator"] = state.generator.get_state()
    out["placed"] = _placed([state.model, state.ema])
    return out


def task_map(mesh, tp=2, steps=2, tile=256):
    """Two CMLPL steps on the mesh, then net B's whole weights (gathered
    by ``state_to_jax``) mapped on the mesh, tiled (the plain gather) and
    dense: the weights, both maps and the tiles this rank mapped."""
    from cmlpl_tpu_torch.cli._common import logits_fn
    from cmlpl_tpu_torch.eval.inference import ScenePredictor
    from cmlpl_tpu_torch.models.basenet import BaseNet2
    from cmlpl_tpu_torch.weights import state_dict_from_jax

    m = mesh_2d(mesh, tp)
    scene, splits = dw.tiny_scene()
    trainer = dw.TRAINERS["cmlpl"](CMLPLConfig(**dw.TINY), device="cpu",
                                   mesh=m)
    state = trainer.init_state(0)
    for (epoch, bi), batch in zip(dw.STEPS, dw.batches(scene, splits,
                                                       steps)):
        state, _ = trainer.train_step(state, scene, *batch, epoch=epoch,
                                      batch_index=bi)
    params = trainer.state_to_jax(state)["net_b"]["params"]
    model = BaseNet2(num_features=103, num_classes=9, n_pc=dw.N_PC,
                     patch_size=dw.W).eval()
    model.load_state_dict(state_dict_from_jax(params))
    calls = []
    fn = logits_fn(model)

    def counted(xp, x):
        calls.append(xp.shape[0])
        return fn(xp, x)

    tiled = ScenePredictor(counted, patch_size=dw.W, cols=scene.cols,
                           tile=tile, gather="xla", mesh=m)(scene)
    dense = ScenePredictor(None, patch_size=dw.W, cols=scene.cols,
                           gather="dense", params=model.state_dict(),
                           mesh=m)(scene)
    return {"params": params, "tiled": tiled, "dense": dense,
            "calls": calls}


def task_fused(mesh, tp=2, algo="cmlpl", num_iters=4):
    """A fused ``num_iters``-seed run (``torch_dist_worker.task_fused``'s)
    on the mesh: this rank's seed block, its seeds' metrics and states,
    and whether those are whole."""
    m = mesh_2d(mesh, tp)
    out = dw.task_fused(m, algo=algo, num_iters=num_iters)
    out["whole"] = all(v.shape[0] == 1024 for st in out["states"]
                       for k, v in st.items()
                       if k.endswith("feat_spe.weight"))
    return out


def task_checkpoint(mesh, tp, directory, steps=2):
    """CMLPL steps on the mesh saved by ``save_checkpoint`` (every rank
    calls it) under ``directory``, restored onto the mesh: the saved
    step's path, the local trees before the save and after the restore,
    and the generators'."""
    from cmlpl_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                  save_checkpoint)

    m = mesh_2d(mesh, tp)
    scene, splits = dw.tiny_scene()
    trainer = dw.TRAINERS["cmlpl"](CMLPLConfig(**dw.TINY), device="cpu",
                                   mesh=m)
    state = trainer.init_state(0)
    for (epoch, bi), batch in zip(dw.STEPS, dw.batches(scene, splits,
                                                       steps)):
        state, _ = trainer.train_step(state, scene, *batch, epoch=epoch,
                                      batch_index=bi)
    path = save_checkpoint(directory, trainer, state)
    barrier(m)
    back = restore_checkpoint(directory, trainer)
    return {"path": path, "saved": local_tree(trainer, state),
            "restored": local_tree(trainer, back),
            "generators": (state.generator.get_state(),
                           back.generator.get_state()),
            "step": back.step}


TASKS = {"coords": task_coords, "grads": task_grads, "layout": task_layout,
         "from_tree": task_from_tree, "steps": task_steps, "zoo": task_zoo,
         "map": task_map, "fused": task_fused, "checkpoint": task_checkpoint}


def task_many(mesh, calls):
    """Each ``[task, kwargs]`` of ``calls`` in turn, in one world."""
    return [TASKS[name](mesh, **kwargs) for name, kwargs in calls]


def run_ranks(task: str, out_dir: str, world: int = 4, **kwargs) -> list:
    """``torch_dist_worker.run_ranks`` of this file's tasks."""
    return dw.run_ranks(task, out_dir, world=world,
                        script=os.path.abspath(__file__), **kwargs)


if __name__ == "__main__":
    dw.TASKS.update(TASKS, many=task_many)
    dw.main()
