"""Shared CLI plumbing for the port's entry points
(``cmlpl_tpu/cli/_common.py``).

The flags have the JAX package's names and defaults (reference
``train.py:355-380``), plus ``--device`` (the CUDA card unless asked for
the CPU).  predict and serve read :func:`base_parser`: a BaseNet2 from
``--weights`` (a param npz in the JAX layout, :mod:`cmlpl_tpu_torch.weights`)
or from the latest checkpoint of ``--checkpoint_dir``, net ``--net``; or,
with ``--model``, any model of the comparison zoo from ``--weights`` as
``train_backbone --weights_out`` writes it (:func:`resolve_model`).
train, train_cps and train_cct read :func:`train_parser`: its
``--weights_out`` writes the trained weights in that layout, and
``--checkpoint_dir`` holds the trainer states that ``--resume`` and
``--max_restarts`` restart from (:mod:`cmlpl_tpu_torch.utils.checkpoint`,
the JAX package's directory contract in a format of the port's own), and
that predict and serve map with.

``--multihost`` (every CLI but sample_generation) joins the ``torchrun``
world before anything else (:func:`setup_runtime`, a no-op for one
process): one process a card, the trainers data parallel over the ranks
and every map split into one strip a rank, of tiles or, dense, of scene
rows (``core/mesh.py``).  Rank 0 reads ``--weights``, ``--checkpoint_dir``
(for ``--resume`` too) and, in predict and serve, the scene and the
requests, and broadcasts what it read; rank 0 writes the files
(``core/mesh.is_primary``) and serve's responses; every rank prints its
results but serve's ranks, whose stdout carries the responses of rank 0
alone.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time
import traceback

import numpy as np
import torch

from cmlpl_tpu_torch.core.mesh import (barrier, broadcast_object,
                                       initialize_multihost, is_primary)
from cmlpl_tpu_torch.data.pipeline import SemiSupervisedSampler
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.data.splits import generate_splits, load_splits
from cmlpl_tpu_torch.eval.inference import GATHERS, ScenePredictor
from cmlpl_tpu_torch.models.basenet import BaseNet2
from cmlpl_tpu_torch.models.zoo import ZOO
from cmlpl_tpu_torch.models.zoo import build_model as build_zoo_model
from cmlpl_tpu_torch.ops.patch_gather import TRAIN_GATHERS
from cmlpl_tpu_torch.registry import get_dataset
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.utils.checkpoint import (load_net_params,
                                              read_checkpoint,
                                              save_checkpoint,
                                              state_from_checkpoint)
from cmlpl_tpu_torch.weights import (load_params_npz, state_dict_from_jax,
                                     zoo_state_dict_from_jax)


def _shared_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataID", type=str, default="1")
    p.add_argument("--num_label", type=int, default=5)
    p.add_argument("--data_root", type=str, default="./dataset")
    p.add_argument("--val_batch_size", type=int, default=512)
    p.add_argument("--dropout", type=float, default=0.8)
    p.add_argument("--w", type=int, default=20)
    p.add_argument("--n_PC", type=int, default=60)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="model compute dtype (params stay float32; "
                        "losses, queues and Adam stay float32 in "
                        "training)")
    p.add_argument("--eval_gather", type=str, default="auto",
                   choices=list(GATHERS),
                   help="full-scene inference patch gather: auto = the f32 "
                        "CUDA kernel on the card / the plain gather on the "
                        "CPU; pallas = the f32 CUDA kernel; pallas_bf16 = "
                        "the bf16 CUDA kernel (patch inputs "
                        "bf16-quantised); xla = the plain PyTorch gather; "
                        "dense = one dilated-conv pass over the whole "
                        "scene, no gather (BaseNet2/CCT, w % 4 == 0)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card, "
                        "cuda:LOCAL_RANK under torchrun); the CPU only when "
                        "asked for")
    return p


def _map_source_flags(p: argparse.ArgumentParser,
                      checkpoint_dir: bool = True) -> None:
    p.add_argument("--weights", type=str, default=None,
                   help="BaseNet2 params as a flat '<layer>/<leaf>' npz in "
                        "the JAX layout (what the training CLIs' "
                        "--weights_out writes; for a zoo --model, "
                        "train_backbone's params and batch_stats); or give "
                        "--checkpoint_dir")
    if checkpoint_dir:
        p.add_argument("--checkpoint_dir", type=str, default=None,
                       help="map with a net of the latest checkpoint here "
                            "(of cli.train or cli.train_cps); or give "
                            "--weights")
    p.add_argument("--net", type=str, default="b", choices=["b", "e"],
                   help="which of the two mutually-trained networks of "
                        "--checkpoint_dir")


def base_parser() -> argparse.ArgumentParser:
    """The flags of predict and serve."""
    p = _shared_parser()
    _map_source_flags(p)
    p.add_argument("--model", type=str, default="basenet2",
                   choices=sorted(ZOO),
                   help="the network of --weights: basenet2 (CMLPL's, the "
                        "default) or any model of the comparison zoo, whose "
                        "--w and --n_PC default to its own (DBDA: 9 and "
                        "all bands), as in train_backbone")
    p.add_argument("--multihost", action="store_true",
                   help="join the torchrun world (MASTER_ADDR, MASTER_PORT, "
                        "RANK, WORLD_SIZE, LOCAL_RANK; NCCL between cards, "
                        "gloo with --device cpu) and map each scene in one "
                        "strip a rank, one process a card; rank 0 reads the "
                        "weights, the scene and the requests; a no-op for "
                        "one process")
    return p


def export_parser() -> argparse.ArgumentParser:
    """The flags of export_model: train's (a training bundle is the run
    those flags describe; ``--checkpoint_dir`` is the map's source, or
    ``--import_run``'s destination) and the map's source."""
    p = train_parser()
    _map_source_flags(p, checkpoint_dir=False)
    return p


def train_parser() -> argparse.ArgumentParser:
    """The flags of train, train_cps and train_cct."""
    p = _shared_parser()
    p.add_argument("--save_path_prefix", type=str, default="./")
    p.add_argument("--metrics_csv", type=str, default=None,
                   help="write the per-step training metrics history "
                        "(losses, accuracy, mask rate) to this CSV")
    p.add_argument("--scene_npz", type=str, default=None,
                   help="load the raw scene from this .npz (arrays 'cube' "
                        "(rows, cols, bands) and 'gt' (rows, cols)) instead "
                        "of the registry .mat files; dataID still supplies "
                        "class count/bands/palette")
    p.add_argument("--splits_dir", type=str, default=None,
                   help="directory holding the reference's materialised "
                        "train_array.npy / test_array.npy / "
                        "unlabel_array.npy; default: regenerate the "
                        "byte-identical splits from --num_label")
    # train (reference train.py:361-368)
    p.add_argument("--labeled_batch_size", type=int, default=128)
    p.add_argument("--unlabeled_batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--num_epochs", type=int, default=20)
    p.add_argument("--print_per_batches", type=int, default=10)
    p.add_argument("--num_unlabel", type=int, default=10000)
    p.add_argument("--thr", type=float, default=1.0)
    p.add_argument("--alpha", type=float, default=0.95)
    p.add_argument("--queue-batch", dest="queue_batch", type=float,
                   default=17)
    p.add_argument("--temperature", type=float, default=0.3)
    p.add_argument("--noise", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=1088)
    p.add_argument("--rng_impl", type=str, default="threefry2x32",
                   choices=["threefry2x32", "rbg"],
                   help="accepted for the JAX package's command lines and "
                        "without effect: the eager trainers draw from Philox "
                        "torch.Generators, an exported training run "
                        "(export_model --train_bundle) from a threefry2x32 "
                        "counter stream")
    p.add_argument("--noise_impl", type=str, default="normal",
                   choices=["normal", "binom16"],
                   help="input-view noise sampler: binom16 = standardised "
                        "Binomial(16,1/2) from a popcount (mean 0 / var 1 "
                        "lattice within +/-4 sigma)")
    p.add_argument("--noise_fused", action="store_true",
                   help="draw each net's labeled||unlabeled noise view "
                        "once over the concatenation (4 draws instead of "
                        "8; same distribution and independence)")
    p.add_argument("--input_dtype", type=str, default="compute",
                   choices=["compute", "float32"],
                   help="dtype of gathered patches, spectra and noise "
                        "views: 'compute' stores them in the compute dtype "
                        "(under bfloat16 the pool is gathered by the bf16 "
                        "CUDA kernel and the views are drawn in bf16), "
                        "'float32' keeps them f32")
    p.add_argument("--gather_impl", type=str, default="auto",
                   choices=list(TRAIN_GATHERS),
                   help="training patch gather: auto (default) = 'pool' "
                        "when the pool fits the 2 GiB budget, else 'pallas' "
                        "on the card and 'xla' on the CPU; "
                        "'pool' gathers the run's unique pixels once with "
                        "the f32 CUDA kernel and takes rows per step; "
                        "'xla' = the plain gather per step; "
                        "'pallas'/'pallas_bf16' = the f32/bf16 CUDA kernel "
                        "per step")
    p.add_argument("--num_iters", type=int, default=1,
                   help="train: repeat training num_iters times and report "
                        "mean±std (reference train.py:116 index_iter loop); "
                        "accepted and ignored by train_cps and train_cct, "
                        "as in the JAX package")
    p.add_argument("--fused_iters", action="store_true",
                   help="train: run all --num_iters runs as ONE step loop "
                        "over seed-stacked states (torch.func.vmap; the "
                        "serial loop's results within rounding; "
                        "incompatible with --resume/--profile_dir/"
                        "--checkpoint_every)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="train: write a torch.profiler Chrome trace (host "
                        "ops and, on the card, its kernels) of the first "
                        "run into this directory; ignored by train_cps, "
                        "train_cct and train_backbone, as in the JAX "
                        "package")
    p.add_argument("--weights_out", type=str, default=None,
                   help="write the trained params as a flat '/'-keyed npz "
                        "in the JAX layout: net B's for train and train_cps "
                        "(what predict and serve read as --weights), the "
                        "CCT tree for train_cct")
    p.add_argument("--extra_loss", type=str, default="",
                   choices=["", "memobank", "mmd", "ntxent"],
                   help="opt-in extra objective (train; ignored by "
                        "train_cps and train_cct, as in the JAX package): "
                        "U2PL memory-bank InfoNCE, labeled/unlabeled MMD, "
                        "or cross-net NT-Xent")
    p.add_argument("--extra_weight", type=float, default=0.1,
                   help="weight of --extra_loss in the total loss")
    p.add_argument("--augment", nargs="*", default=[],
                   choices=["flip", "rot90", "radiation", "mixture"],
                   help="opt-in patch augmentations (train; "
                        "hsi_loader.py:58-107, dead in the reference)")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="write the trainer state here at the end of the "
                        "run (and every --checkpoint_every epochs), as "
                        "<dir>/<step>/")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="save a checkpoint every N epochs (0 = only at "
                        "the end, with --checkpoint_dir)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "--checkpoint_dir")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="on a training failure, retry the run up to N "
                        "times in the same process, resuming from the "
                        "latest checkpoint in --checkpoint_dir (required; "
                        "pair with --checkpoint_every for mid-run restart "
                        "points)")
    # fault injection for the recovery tests: raise RuntimeError in the
    # epoch hook right after epoch N's checkpoint is written
    p.add_argument("--fail_at_epoch", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--multihost", action="store_true",
                   help="join the torchrun world (MASTER_ADDR, MASTER_PORT, "
                        "RANK, WORLD_SIZE, LOCAL_RANK; NCCL between cards, "
                        "gloo with --device cpu) and train data parallel, "
                        "one process a card; a no-op for one process")
    return p


def setup_runtime(args, file=None) -> None:
    """Process-level set-up before any device work: with --multihost,
    joins the torchrun world (``core/mesh.initialize_multihost``, a no-op
    for one process) on ``--device``'s backend, and says so on ``file``
    (default: stdout)."""
    if getattr(args, "multihost", False):
        n = initialize_multihost(device=args.device)
        print(f"multihost: {n} process(es)", file=file)


def build_config(args, spec) -> CMLPLConfig:
    return CMLPLConfig(
        num_classes=spec.num_classes,
        num_features=spec.num_bands,
        num_label=args.num_label,
        n_pc=args.n_PC,
        patch_size=args.w,
        labeled_batch=args.labeled_batch_size,
        unlabeled_batch=args.unlabeled_batch_size,
        val_batch=args.val_batch_size,
        lr=args.lr,
        num_epochs=args.num_epochs,
        num_unlabel=args.num_unlabel,
        thr=args.thr,
        alpha=args.alpha,
        queue_batch=int(args.queue_batch),
        temperature=args.temperature,
        dropout=args.dropout,
        noise=args.noise,
        seed=args.seed,
        compute_dtype=args.compute_dtype,
        input_dtype=args.input_dtype,
        rng_impl=args.rng_impl,
        noise_impl=args.noise_impl,
        noise_fused=args.noise_fused,
        gather_impl=args.gather_impl,
        extra_loss=args.extra_loss,
        extra_weight=args.extra_weight,
        augment=tuple(args.augment),
    )


def build_scene(args, device, patch_size: int | None = None,
                n_pc: int | None = None):
    """(spec, scene on ``device``, splits) from the flags; the scene's
    patch size and channels are ``--w`` and ``--n_PC`` unless given."""
    spec = get_dataset(args.dataID)
    cube = gt = None
    if args.scene_npz:
        with np.load(args.scene_npz) as z:
            cube, gt = z["cube"], z["gt"]
    scene = prepare_scene(
        spec, root=args.data_root,
        patch_size=args.w if patch_size is None else patch_size,
        n_pc=args.n_PC if n_pc is None else n_pc, cube=cube, gt=gt,
        device=device)
    if args.splits_dir:
        splits = load_splits(args.splits_dir)
    else:
        splits = generate_splits(scene.labels, num_label=args.num_label)
    return spec, scene, splits


def build_data(args, device):
    """(spec, scene on ``device``, splits, sampler) from the flags."""
    spec, scene, splits = build_scene(args, device)
    sampler = SemiSupervisedSampler(
        splits, scene.labels, args.labeled_batch_size,
        args.unlabeled_batch_size, num_unlabel=args.num_unlabel,
        seed=args.seed)
    return spec, scene, splits, sampler


def save_path(args, spec) -> str:
    path = os.path.join(args.save_path_prefix, f"Experiment_{spec.data_id}",
                        f"label_{args.num_label}")
    os.makedirs(path, exist_ok=True)
    return path


def save_history(args, history) -> None:
    """--metrics_csv: the per-step metric dicts of ``fit``, one row per
    step with the step number first (the reference only prints running
    means, train.py:274-289)."""
    if not args.metrics_csv or not history or not is_primary():
        return
    keys = list(history[0])
    with open(args.metrics_csv, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(["step"] + keys)
        out.writerows([i] + [float(m[k]) for k in keys]
                      for i, m in enumerate(history))
    print(f"wrote {args.metrics_csv} ({len(history)} steps)")


def entry_shape(args, entry, spec) -> tuple[int, int]:
    """(w, n_pc): ``--w`` and ``--n_PC`` where they differ from the
    training CLIs' defaults (20, 60), else the entry's own; n_pc -1 is
    all of ``spec``'s bands (``cmlpl_tpu/cli/train_backbone.py:51-56``)."""
    w = args.w if args.w != 20 or entry.default_patch == 20 \
        else entry.default_patch
    n_pc = args.n_PC if args.n_PC != 60 or entry.default_n_pc == 60 \
        else entry.default_n_pc
    return w, spec.num_bands if n_pc == -1 else n_pc


def resolve_model(args, spec):
    """The zoo entry of predict's and serve's ``--model``, with ``--w``
    and ``--n_PC`` set in ``args`` to the entry's own where they were left
    at their defaults (:func:`entry_shape`; for basenet2 they stay as
    given).  A zoo model other than basenet2 is read from ``--weights``
    alone (a checkpoint of ``--checkpoint_dir`` holds CMLPL's BaseNet2s),
    is refused ``--eval_gather dense`` (ValueError, as train_backbone
    refuses it: the dense pass needs BaseNet2-shaped params), and a model
    of all the bands (``default_n_pc`` -1: DBDA, SSRN, FDSSC) takes
    ``--n_PC`` = the dataset's bands."""
    entry = ZOO[args.model]
    args.w, args.n_PC = entry_shape(args, entry, spec)
    if args.model == "basenet2":
        return entry
    if args.checkpoint_dir:
        raise SystemExit(f"--model {args.model} maps --weights alone: "
                         "--checkpoint_dir holds CMLPL's BaseNet2s")
    if args.eval_gather == "dense":
        raise ValueError(f"--eval_gather dense maps BaseNet2 alone, not "
                         f"--model {args.model}; use a tiled gather")
    if entry.default_n_pc == -1 and args.n_PC != spec.num_bands:
        raise SystemExit(f"--model {args.model} takes all {spec.num_bands} "
                         f"bands of {spec.name}: --n_PC {args.n_PC} given")
    return entry


def build_model(args, spec, device, mesh=None) -> torch.nn.Module:
    """BaseNet2 for ``spec`` with the params of ``--weights`` or of net
    ``--net`` of ``--checkpoint_dir``'s latest checkpoint (exactly one of
    the two), in eval mode; with ``--model`` another zoo model, from the
    ``{"params", "batch_stats"}`` of ``--weights`` (its BatchNorms then
    use those running statistics).  Over ``mesh`` rank 0 alone reads the
    file (the others may not see it) and broadcasts the params, or the
    error it met, which every rank then raises."""
    if bool(args.weights) == bool(args.checkpoint_dir):
        raise SystemExit("give one of --weights and --checkpoint_dir"
                         + (", not both" if args.weights else ""))
    name = getattr(args, "model", "basenet2")
    params = error = None
    if mesh is None or is_primary(mesh):
        try:
            params = (load_params_npz(args.weights) if args.weights else
                      load_net_params(args.checkpoint_dir, args.net))
            if name != "basenet2" and "params" not in params:
                raise ValueError(
                    f"{args.weights} holds no params/ tree: --model {name} "
                    "reads what train_backbone --weights_out writes")
        except Exception as e:  # every rank raises it, below
            error = e
    params, error = broadcast_object((params, error), mesh)
    if error is not None:
        raise error
    if name == "basenet2":
        model = BaseNet2(num_features=spec.num_bands, dropout=args.dropout,
                         num_classes=spec.num_classes, n_pc=args.n_PC,
                         patch_size=args.w, compute_dtype=args.compute_dtype)
        model.load_state_dict(state_dict_from_jax(params))
    else:
        model, _ = build_zoo_model(name, spec, args.n_PC, args.w)
        model.load_state_dict(zoo_state_dict_from_jax(name, params))
    return model.to(device).eval()


def logits_fn(model: torch.nn.Module, name: str = "basenet2"):
    """``(xp, x) -> logits`` of a BaseNet2 or of zoo model ``name``, for
    ``ScenePredictor``: a "patch" model takes no ``x``, and a model that
    returns (logits, feature) gives its logits."""
    entry = ZOO[name]
    if entry.inputs == "dual":
        return lambda xp, x: model(xp, x)[0]
    if entry.returns_feature:
        return lambda xp, x: model(xp)[0]
    return lambda xp, x: model(xp)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_epoch_hook(args, trainer):
    """``fit``'s ``on_epoch_end`` for ``--checkpoint_every`` (a checkpoint
    every N epochs, with ``--checkpoint_dir``) and ``--fail_at_epoch``, or
    None when neither is set.

    ``--fail_at_epoch N`` raises after epoch N's checkpoint is written, so
    a retry by :func:`run_resilient` resumes at epoch N and never meets
    the injection point again: one failure, deterministically."""
    every = args.checkpoint_every if args.checkpoint_dir else 0
    fail_at = args.fail_at_epoch
    if not every and not fail_at:
        return None

    def hook(epoch, state):
        if every and (epoch + 1) % every == 0:
            save_state(args, trainer, state)
        if fail_at and epoch + 1 == fail_at:
            raise RuntimeError(
                f"fault injection: failing after epoch {epoch + 1}")

    return hook


def run_resilient(entry, argv=None):
    """Run ``entry(argv)``; on a training failure, retry it up to
    ``--max_restarts`` times in the same process with ``--resume``
    appended, so a retry continues from the latest checkpoint and a
    failure costs at most ``--checkpoint_every`` epochs.  Without
    ``--checkpoint_dir`` a retry would repeat the run from scratch, so the
    failure is raised instead.  Exits and interrupts are never retried."""
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    probe = argparse.ArgumentParser(add_help=False)
    probe.add_argument("--max_restarts", type=int, default=0)
    probe.add_argument("--checkpoint_dir", type=str, default=None)
    known, _ = probe.parse_known_args(argv)
    attempts = 0
    while True:
        try:
            return entry(argv)
        except Exception as e:
            attempts += 1
            if attempts > known.max_restarts or not known.checkpoint_dir:
                raise
            traceback.print_exc()
            print(f"training attempt failed ({type(e).__name__}: {e}); "
                  f"restart {attempts}/{known.max_restarts} from the "
                  "latest checkpoint")
            if "--resume" not in argv:
                argv.append("--resume")


def maybe_resume(args, trainer, state, batches_per_epoch: int):
    """``--resume``: the latest checkpoint of ``--checkpoint_dir`` in
    place of ``state``, and the epoch to start from, ``step //
    batches_per_epoch``; returns (state, start_epoch).  The run then draws
    its batches afresh from the sampler's first epoch, as the JAX
    package's does.  Over a trainer's mesh rank 0 alone reads the
    directory (the others may not see it) and broadcasts what it found,
    the files or none; every rank builds its state from them."""
    if not (args.resume and args.checkpoint_dir):
        return state, 0
    mesh = getattr(trainer, "mesh", None)
    found = None
    if is_primary(mesh):
        try:
            found = read_checkpoint(args.checkpoint_dir)
        except FileNotFoundError:
            pass
    found = broadcast_object(found, mesh)
    if found is None:
        print("no checkpoint to resume from; starting fresh")
        return state, 0
    state = state_from_checkpoint(trainer, *found)
    start_epoch = state.step // batches_per_epoch
    print(f"resumed from step {state.step} (epoch {start_epoch})")
    return state, start_epoch


def save_state(args, trainer, state) -> None:
    """The trainer state under ``--checkpoint_dir``, written by rank 0 of
    the trainer's mesh (the replicas are equal); every rank waits for
    it."""
    save_checkpoint(args.checkpoint_dir, trainer, state)
    barrier(getattr(trainer, "mesh", None))


def save_final_checkpoint(args, trainer, state) -> None:
    if args.checkpoint_dir:
        save_state(args, trainer, state)


def timed_fit(trainer, state, scene, sampler, log_every: int,
              start_epoch: int = 0, on_epoch_end=None):
    """``trainer.fit`` between two device synchronises; prints the
    "training time == <s>s (<n> steps)" line.  Returns (state, history)."""
    sync(trainer.device)
    t0 = time.perf_counter()
    state, history = trainer.fit(state, scene, sampler, log_every=log_every,
                                 start_epoch=start_epoch,
                                 on_epoch_end=on_epoch_end)
    sync(trainer.device)
    print(f"training time == {time.perf_counter() - t0:.3f}s "
          f"({len(history)} steps)")
    return state, history


def scene_map(args, scene, model_fn, params, name: str,
              spectra: bool = True, mesh=None) -> np.ndarray:
    """The full-scene map of a trained model with ``--eval_gather``:
    ``model_fn(xp, x) -> logits`` for the tiled modes, its ``state_dict``
    ``params`` for "dense"; ``spectra=False`` for a model of patches only;
    over ``mesh``, one strip a rank (of tiles, or of scene rows for
    "dense") and the whole map on every rank.  Prints the "full-scene
    inference time (<name>) == <s>s" line."""
    predictor = ScenePredictor(model_fn, params=params,
                               patch_size=scene.patch_size, cols=scene.cols,
                               tile=args.val_batch_size,
                               gather=args.eval_gather, spectra=spectra,
                               mesh=mesh)
    t0 = time.perf_counter()
    pred = predictor(scene)
    print(f"full-scene inference time ({name}) == "
          f"{time.perf_counter() - t0:.3f}s")
    return pred


def report_accuracy(name: str, acc) -> None:
    print(f"Result ({name}):\n OA={acc.oa * 100:.2f}, "
          f"Kappa={acc.kappa * 100:.2f}")
    print("producerA:", np.array2string(acc.producer * 100, precision=2))
    print(f"AA={acc.aa * 100:.2f}")
