"""One rank of the port's data-parallel tests (``tests/test_torch_port_dp_*``).

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_dist_worker.py <task> <out_dir> [json kwargs]

joins the gloo world on the CPU through the CLIs' entry point
(``core/mesh.initialize_multihost``), runs ``task`` on the mesh and saves
what it returns as ``<out_dir>/rank<r>.pt``.  The tests run the same task
functions in their own process with ``mesh=None`` for the one-process
reference; nothing here imports JAX.  :func:`run_ranks` starts the ranks.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cmlpl_tpu_torch.core.mesh import (all_gather_rows,  # noqa: E402
                                       create_mesh, gather_rows,
                                       initialize_multihost, shard_rows)
from cmlpl_tpu_torch.data.io import synthetic_scene  # noqa: E402
from cmlpl_tpu_torch.data.pipeline import SemiSupervisedSampler  # noqa: E402
from cmlpl_tpu_torch.data.prep import prepare_scene  # noqa: E402
from cmlpl_tpu_torch.data.splits import generate_splits  # noqa: E402
from cmlpl_tpu_torch.train import (CCTTrainer, CMLPLTrainer,  # noqa: E402
                                   CPSTrainer)
from cmlpl_tpu_torch.train.state import CMLPLConfig  # noqa: E402

N_PC, W = 16, 20
#: 8 labeled + 16 unlabeled rows a step: at two ranks rank 0 holds the 8
#: labeled and 4 unlabeled rows, so every split crosses the boundary
TINY = dict(num_classes=9, num_features=103, n_pc=N_PC, patch_size=W,
            labeled_batch=8, unlabeled_batch=16, num_unlabel=64,
            num_epochs=2, noise=0.5, dropout=0.5, thr=0.13, queue_batch=1)
TRAINERS = {"cmlpl": CMLPLTrainer, "cps": CPSTrainer, "cct": CCTTrainer}
STEPS = [(0, 0), (0, 2), (1, 0)]        # (epoch, batch index)


def tiny_scene():
    cube, gt = synthetic_scene(0)
    scene = prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC,
                          device="cpu")
    return scene, generate_splits(scene.labels, num_label=5)


def batches(scene, splits, n, seed=3):
    it = SemiSupervisedSampler(splits, scene.labels, 8, 16, num_unlabel=64,
                               seed=seed).epoch()
    return [next(it) for _ in range(n)]


def state_tensors(trainer, state) -> dict:
    """Every tensor of a trainer state by name: params, Adam moments and
    steps, carried tensors, the generator's state and the step."""
    out = {f"param/{k}": v.detach().clone()
           for k, v in trainer.named_params(state).items()}
    names = {id(p): k for k, p in trainer.named_params(state).items()}
    for i, opt in enumerate(trainer._opts(state)):
        for p, st in opt.state.items():
            for k, v in st.items():
                out[f"opt{i}/{names[id(p)]}/{k}"] = v.clone()
    for name, c in trainer._carry(state).items():
        fields = c.__dict__ if hasattr(c, "__dict__") else c._asdict()
        for k, v in fields.items():
            out[f"{name}/{k}"] = torch.as_tensor(v).clone()
    out["generator"] = state.generator.get_state()
    out["step"] = torch.tensor(state.step)
    return out


# -- tasks ------------------------------------------------------------------ #
def task_gather(mesh):
    """The gather Function and the sharded call's input gradient on 24
    rows (8 labeled, 16 unlabeled) from one seed."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(24, 5, generator=g)
    w = torch.randn(24, 5, generator=g)
    lo, hi = (0, 24) if mesh is None else mesh.rows(24)
    local = x[lo:hi].clone().requires_grad_(True)
    gathered = all_gather_rows(local, mesh)
    (gathered * w).sum().backward()
    # a sharded call on a replicated input that needs a gradient
    rep = x.clone().requires_grad_(True)
    lin = torch.randn(5, 3, generator=g)
    out = all_gather_rows(torch.tanh(shard_rows(rep, mesh) @ lin), mesh)
    ((out * out).sum() + rep.pow(3).sum()).backward()
    bf16 = x.to(torch.bfloat16)[lo:hi]
    ids = torch.arange(lo, hi, dtype=torch.int32) * 7
    return {"x": x, "w": w, "lo": lo, "hi": hi, "gathered":
            gathered.detach(), "grad": local.grad, "rep_grad": rep.grad,
            "out": out.detach(), "bf16": gather_rows(bf16, mesh, lo, 24),
            "int32": gather_rows(ids, mesh, lo, 24)}


def task_steps(mesh, algo="cmlpl", extra_loss="", noise=0.5, dropout=0.5,
               steps=3):
    """``steps`` steps of ``algo`` from ``init_state(0)`` on the tiny
    scene: each step's metrics, the step-1 gradients (summed over the
    ranks), the state after step 1 and after the last."""
    scene, splits = tiny_scene()
    cfg = CMLPLConfig(**dict(TINY, noise=noise, dropout=dropout),
                      extra_loss=extra_loss)
    trainer = TRAINERS[algo](cfg, device="cpu", mesh=mesh)
    state = trainer.init_state(0)
    out = {"metrics": [], "initial": state_tensors(trainer, state)}
    for i, ((epoch, bi), (li, ly, ui)) in enumerate(
            zip(STEPS[:steps], batches(scene, splits, steps))):
        state, m = trainer.train_step(state, scene, li, ly, ui, epoch=epoch,
                                      batch_index=bi)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["grads"] = {k: p.grad.clone() for k, p in
                            trainer.named_params(state).items()}
            out["after1"] = state_tensors(trainer, state)
    out["final"] = state_tensors(trainer, state)
    return out


def task_from_tree(mesh, algo, tree_npz, batches_npz, steps):
    """Noise-off steps of ``algo`` from a JAX-layout state (``tree_npz``)
    on the batches of ``batches_npz`` (li, ly, ui, epoch, bi stacked):
    each step's metrics and the final JAX-layout state."""
    from cmlpl_tpu_torch.weights import StateTree, load_params_npz

    scene, _ = tiny_scene()
    cfg = CMLPLConfig(**dict(TINY, noise=0.0, dropout=0.0))
    trainer = TRAINERS[algo](cfg, device="cpu", mesh=mesh)
    state = trainer.place(trainer.state_from_jax(
        StateTree(load_params_npz(tree_npz))))
    b = np.load(batches_npz)
    metrics = []
    for i in range(steps):
        state, m = trainer.train_step(
            state, scene, b["li"][i], b["ly"][i], b["ui"][i],
            epoch=int(b["epoch"][i]), batch_index=int(b["bi"][i]))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "tree": trainer.state_to_jax(state)}


def task_map(mesh, tiles=(256,), seed=11):
    """For each tile size, the tiled map of a BaseNet2 of random weights
    (``seed``) over the ranks, and the tiles this rank's model was called
    on."""
    from cmlpl_tpu_torch.cli._common import logits_fn
    from cmlpl_tpu_torch.eval.inference import ScenePredictor
    from cmlpl_tpu_torch.models.basenet import BaseNet2
    from cmlpl_tpu_torch.weights import (init_basenet2_params,
                                         state_dict_from_jax)

    scene, _ = tiny_scene()
    model = BaseNet2(num_features=103, num_classes=9, n_pc=N_PC,
                     patch_size=W).eval()
    model.load_state_dict(state_dict_from_jax(init_basenet2_params(
        seed, n_pc=N_PC, num_features=103, num_classes=9, patch_size=W)))
    fn, out = logits_fn(model), {}
    for tile in tiles:
        calls = []

        def counted(xp, x):
            calls.append(xp.shape[0])
            return fn(xp, x)

        labels = ScenePredictor(counted, patch_size=W, cols=scene.cols,
                                tile=tile, gather="xla", mesh=mesh)(scene)
        out[tile] = {"labels": labels, "calls": calls}
    return out


def task_fused(mesh, algo="cmlpl", num_iters=4):
    """A fused ``num_iters``-seed run of ``algo`` (2 epochs): this rank's
    seeds, their metrics and final states."""
    scene, splits = tiny_scene()
    trainer = TRAINERS[algo](CMLPLConfig(**TINY), device="cpu", mesh=mesh)
    sampler = SemiSupervisedSampler(splits, scene.labels, 8, 16, 64, seed=7)
    states, metrics = trainer.train_multi_run(1088, scene, sampler,
                                              num_iters)
    return {"block": trainer.seed_block(num_iters), "metrics": metrics,
            "states": [state_tensors(trainer, st) for st in states]}


def task_cli(mesh, runs, cwd):
    """Each ``(cli module, argv)`` of ``runs`` in turn, in ``cwd``: what
    its ``main`` printed and its OAs; after a run with
    ``--checkpoint_dir``, the state that ``--resume`` restores from it.
    An ``argv`` of lists is one argv a rank (a directory that only rank 0
    sees, as on disks local to each host)."""
    import importlib

    from cmlpl_tpu_torch.cli._common import (build_config, maybe_resume,
                                             train_parser)
    from cmlpl_tpu_torch.eval.metrics import Accuracy
    from cmlpl_tpu_torch.registry import get_dataset

    os.chdir(cwd)
    out = {"printed": [], "oa": [], "resumed": []}
    for module, argv in runs:
        if isinstance(argv[0], list):
            argv = argv[mesh.rank]
        main = importlib.import_module(f"cmlpl_tpu_torch.cli.{module}").main
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            accs = main(argv)
        out["printed"].append(buf.getvalue())
        out["oa"].append([a.oa for a in (
            (accs,) if isinstance(accs, Accuracy) else accs)])
        if module != "train":
            continue
        args = train_parser().parse_args(argv + ["--resume"])
        if args.checkpoint_dir:
            trainer = CMLPLTrainer(build_config(args, get_dataset(0)),
                                   device="cpu", mesh=mesh)
            with contextlib.redirect_stdout(io.StringIO()):
                state, epoch = maybe_resume(args, trainer,
                                            trainer.init_state(0), 1)
            out["resumed"].append(state_tensors(trainer, state))
    return out


# -- the supervised trainer and the zoo ------------------------------------ #
#: the zoo's small size (``tests/test_torch_port_zoo.py``, 16 bands, 4
#: classes) on the 16x14 scene of ``tests/test_torch_port_supervised.py``
#: (3 labels a class: 12), batches of 6: 3 rows a rank at two ranks
ZOO_SHAPES = {"basenet1": (8, 5), "basenet2": (8, 6),
              "basenet2_zoo": (8, 6), "ssftt": (7, 5), "dbda": (5, 16),
              "dbda_feature": (5, 16), "ssrn": (7, 16), "fdssc": (5, 16),
              "msvit": (8, 6)}
ZOO_BANDS, ZOO_CLASSES, ZOO_BATCH = 16, 4, 6


def zoo_cube():
    """The (16, 14, 16) cube and ground truth of
    ``tests/test_torch_port_supervised.py``'s scene."""
    rng = np.random.default_rng(0)
    gt = rng.integers(1, ZOO_CLASSES + 1, size=(16, 14))
    cube = (rng.normal(size=(ZOO_CLASSES + 1, ZOO_BANDS))[gt] * 2
            + rng.normal(size=(16, 14, ZOO_BANDS))).astype(np.float32)
    return cube, gt


def zoo_setup(name, mesh, **kw):
    """(trainer of ``name`` on the CPU over ``mesh``, its scene at the
    entry's small (w, n_pc), the train ids)."""
    import dataclasses

    from cmlpl_tpu_torch.registry import get_dataset
    from cmlpl_tpu_torch.train.supervised import SupervisedTrainer

    w, n_pc = ZOO_SHAPES[name]
    spec = dataclasses.replace(get_dataset(0), num_classes=ZOO_CLASSES,
                               num_bands=ZOO_BANDS)
    cube, gt = zoo_cube()
    scene = prepare_scene(spec, cube=cube, gt=gt, patch_size=w, n_pc=n_pc,
                          device="cpu")
    trainer = SupervisedTrainer(name, spec, patch_size=w, n_pc=n_pc,
                                device="cpu", mesh=mesh, **kw)
    return trainer, scene, generate_splits(scene.labels, num_label=3).train


def zoo_tensors(state) -> dict:
    """Every tensor of a supervised state by name: the model's params and
    BN statistics, the EMA teacher's, the Adam moments and steps, the
    generator's state and the step.  An Adam entry that never stepped is
    left out: a placed state (``place_state`` rebuilds it from the JAX
    tree) carries zero moments for a param that never has a gradient
    (BaseNet2Zoo's feature head), where a fresh one has none."""
    out = {f"model/{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}
    if state.ema is not None:
        out.update({f"ema/{k}": v.detach().clone()
                    for k, v in state.ema.state_dict().items()})
    for k, p in state.model.named_parameters():
        st = state.opt.state.get(p, {})
        if st and float(st["step"]) > 0:
            out.update({f"opt/{k}/{m}": v.clone() for m, v in st.items()})
    out["generator"] = state.generator.get_state()
    out["step"] = torch.tensor(state.step)
    return out


def task_zoo(mesh, name, steps=3, augment=True, ema_alpha=0.9):
    """``steps`` supervised steps of zoo model ``name`` from
    ``init_state(0)``, augmentations and dropout on, an EMA teacher: each
    step's metrics, the step-1 gradients (summed over the ranks), the
    state after step 1 and after the last."""
    trainer, scene, train = zoo_setup(name, mesh, augment=augment,
                                      ema_alpha=ema_alpha)
    state = trainer.init_state(0)
    li, ly = trainer._schedule(train, scene.labels, ZOO_BATCH, 2, None, 3)
    out = {"metrics": [], "batch": li.shape[1]}
    for i in range(steps):
        state, m = trainer.train_step(state, scene, li[i], ly[i])
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["grads"] = {k: p.grad.clone() for k, p in
                            state.model.named_parameters()
                            if p.grad is not None}
            out["after1"] = zoo_tensors(state)
    out["final"] = zoo_tensors(state)
    return out


def task_zoo_from_tree(mesh, name, tree_npz, batches_npz, steps):
    """Supervised steps of ``name`` (no augmentation, no EMA) from a
    JAX-layout state (``tree_npz``) on the batches of ``batches_npz``
    (li, ly stacked): each step's metrics, the step-1 gradients and the
    final JAX-layout state."""
    from cmlpl_tpu_torch.weights import (StateTree, load_params_npz,
                                         supervised_state_to_jax)

    trainer, scene, _ = zoo_setup(name, mesh)
    state = trainer.place(trainer.state_from_jax(
        StateTree(load_params_npz(tree_npz))))
    b = np.load(batches_npz)
    out = {"metrics": []}
    for i in range(steps):
        state, m = trainer.train_step(state, scene, b["li"][i], b["ly"][i])
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["grads"] = {k: p.grad.clone() for k, p in
                            state.model.named_parameters()
                            if p.grad is not None}
    out["tree"] = supervised_state_to_jax(state)
    return out


def task_dense(mesh, seeds, rows=61, cols=23):
    """The dense map over the ranks (``ScenePredictor(gather="dense",
    mesh=)``) of BaseNet2 and CCT weights (``seeds``: the init seeds) on a
    ``rows`` x ``cols`` crop of the synthetic scene, by kind."""
    from cmlpl_tpu_torch.eval.inference import ScenePredictor
    from cmlpl_tpu_torch.weights import (init_basenet2_params,
                                         init_cct_params,
                                         state_dict_from_jax)

    scene = dense_scene(rows, cols)
    shape = dict(n_pc=N_PC, num_features=103, num_classes=9, patch_size=W)
    out = {}
    for kind, init in (("basenet2", init_basenet2_params),
                       ("cct", init_cct_params)):
        params = state_dict_from_jax(init(seeds[kind], **shape))
        out[kind] = ScenePredictor(None, patch_size=W, cols=scene.cols,
                                   gather="dense", params=params,
                                   mesh=mesh)(scene)
    return out


def dense_scene(rows=61, cols=23):
    """A ``rows`` x ``cols`` crop of the synthetic scene (61 rows divide
    over neither 2 nor 3 ranks)."""
    cube, gt = synthetic_scene(0)
    return prepare_scene(0, cube=cube[:rows, :cols], gt=gt[:rows, :cols],
                         patch_size=W, n_pc=N_PC, device="cpu")


def task_raises(mesh, module, argv, cwd):
    """``main(argv)`` of CLI ``module`` in ``cwd``, which must raise: the
    exception's type and message."""
    import importlib

    os.chdir(cwd)
    main = importlib.import_module(f"cmlpl_tpu_torch.cli.{module}").main
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            main(argv)
    except Exception as e:  # noqa: BLE001 - reported to the test
        return {"type": type(e).__name__, "msg": str(e)}
    return {"type": None, "msg": ""}


def task_serve(mesh, predict_runs=(), serve_runs=()):
    """Each argv of ``predict_runs`` (or a list of them, one a rank) given
    to ``cli.predict.main``: its map and what it printed; each ``(argv,
    stdin text)`` of ``serve_runs`` given to ``cli.serve.main``: all it
    wrote to stdout, how far it read its stdin and its scene broadcasts;
    then the tiny scene, prepared on rank 0 alone, through
    ``core/mesh.broadcast_scene``."""
    from cmlpl_tpu_torch.cli import predict, serve
    from cmlpl_tpu_torch.core.mesh import SCENE_BROADCASTS, broadcast_scene

    rank = 0 if mesh is None else mesh.rank
    out = {"predict": [], "serve": []}
    for argv in predict_runs:
        if isinstance(argv[0], list):
            argv = argv[rank]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            labels = predict.main(argv)
        out["predict"].append({"labels": labels, "printed": buf.getvalue()})
    for argv, text in serve_runs:
        stdin, buf = io.StringIO(text), io.StringIO()
        SCENE_BROADCASTS.reset()
        with contextlib.redirect_stdout(buf):
            serve.main(argv, stdin=stdin)
        out["serve"].append({"stdout": buf.getvalue(),
                             "stdin_read": stdin.tell(),
                             "broadcasts": (SCENE_BROADCASTS.calls,
                                            SCENE_BROADCASTS.bytes)})
    SCENE_BROADCASTS.reset()
    scene = broadcast_scene(tiny_scene()[0] if rank == 0 else None, mesh)
    out["scene"] = {"padded_pca": scene.padded_pca, "spectra": scene.spectra,
                    "labels": scene.labels, "spec": scene.spec,
                    "patch_size": scene.patch_size, "n_pc": scene.n_pc,
                    "broadcasts": (SCENE_BROADCASTS.calls,
                                   SCENE_BROADCASTS.bytes)}
    return out


def task_serve_spans(mesh, argv, text):
    """``cli.serve.main(argv)`` fed ``text`` inside a profiler session:
    how many spans of each name it recorded."""
    from torch.profiler import ProfilerActivity, profile

    from cmlpl_tpu_torch.cli import serve
    from cmlpl_tpu_torch.utils.profiling import take_spans

    take_spans()
    with contextlib.redirect_stdout(io.StringIO()), \
            profile(activities=[ProfilerActivity.CPU]):
        serve.main(argv, stdin=io.StringIO(text))
    counts: dict = {}
    for s in take_spans():
        counts[s.name] = counts.get(s.name, 0) + 1
    return counts


def task_init(mesh):
    """``initialize_multihost`` called again (idempotent) and the mesh."""
    return {"again": initialize_multihost(device="cpu"), "rank": mesh.rank,
            "size": mesh.size, "backend": mesh.backend}


def task_many(mesh, calls):
    """Each ``[task, kwargs]`` of ``calls`` in turn, in one world: a list
    of their results (a rank process costs seconds to start)."""
    return [TASKS[name](mesh, **kwargs) for name, kwargs in calls]


TASKS = {"gather": task_gather, "steps": task_steps,
         "from_tree": task_from_tree, "map": task_map, "fused": task_fused,
         "cli": task_cli, "init": task_init, "many": task_many,
         "zoo": task_zoo, "zoo_from_tree": task_zoo_from_tree,
         "dense": task_dense, "raises": task_raises, "serve": task_serve,
         "serve_spans": task_serve_spans}


# -- the parent's side ------------------------------------------------------ #
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(task: str, out_dir: str, world: int = 2, timeout=240,
              script: str | None = None, **kwargs) -> list:
    """Runs ``task(mesh, **kwargs)`` on ``world`` gloo ranks, one process
    each (of ``script``, a worker with this file's command line: this
    file by default); returns each rank's result, in rank order.  A rank
    that fails fails the caller with its output."""
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(script or __file__), task, out_dir,
         json.dumps(kwargs)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def main():
    task, out_dir, kwargs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    torch.set_num_threads(1)
    n = initialize_multihost(device="cpu")
    mesh = create_mesh("cpu")
    assert n == mesh.size == int(os.environ["WORLD_SIZE"])
    result = TASKS[task](mesh, **kwargs)
    torch.save(result, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
