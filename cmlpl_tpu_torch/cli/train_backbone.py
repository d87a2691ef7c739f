"""Supervised backbone training CLI (``cmlpl_tpu/cli/train_backbone.py``):
any model of the comparison zoo (reference ``tools/conpared_models.py``)
trained by cross-entropy on the labeled split, then the full-scene map,
the OA/AA/Kappa report, ``<model>_OA_*.svg`` and ``<model>_results.csv``.

    python -m cmlpl_tpu_torch.cli.train_backbone --dataID 1 --model ssftt \\
        --num_epochs 100

Runs on the CUDA card unless ``--device cpu``.  ``--w`` and ``--n_PC``
default to the entry's own (``models/zoo.ZOO``; ``-1`` = all bands), as in
the JAX CLI.  ``--ema_teacher A`` keeps an EMA teacher and maps it too;
``--augment`` (any of its values) turns on flip, rot90 and radiation
noise; ``--epoch_samples N`` tiles the labeled split to N a epoch.  The
checkpoint flags work as in ``cli.train``.  ``--eval_gather dense`` raises
ValueError, as in the JAX CLI: the dense pass needs BaseNet2-shaped
params.  ``--scene_npz`` and ``--splits_dir`` are read (the JAX CLI
accepts and ignores them).  ``--multihost`` trains data parallel over the
``torchrun`` world, one process a card (``train/supervised.py``: the
BatchNorms take the global batch's statistics, the batch is rounded to a
multiple of the ranks), and maps in one strip of tiles a rank; every rank
prints the same results and rank 0 writes the files.  ``--weights_out``
writes the model's ``{"params", "batch_stats"}`` as a flat JAX-layout
npz.  The flags of the
semi-supervised CLIs that mean nothing here are accepted and ignored, as
in the JAX package.
"""

from __future__ import annotations

import os
import time

from cmlpl_tpu_torch.cli._common import (build_scene, entry_shape,
                                         is_primary, make_epoch_hook,
                                         maybe_resume,
                                         report_accuracy, run_resilient,
                                         save_final_checkpoint, save_history,
                                         save_path, scene_map, setup_runtime,
                                         sync, train_parser)
from cmlpl_tpu_torch.core.mesh import create_mesh
from cmlpl_tpu_torch.device import resolve_device
from cmlpl_tpu_torch.eval.metrics import cal_accuracy
from cmlpl_tpu_torch.eval.report import save_report
from cmlpl_tpu_torch.eval.visualize import save_class_map
from cmlpl_tpu_torch.models.zoo import ZOO
from cmlpl_tpu_torch.registry import get_dataset
from cmlpl_tpu_torch.train.supervised import SupervisedTrainer
from cmlpl_tpu_torch.weights import save_params_npz, zoo_variables_to_jax


def parser():
    """The flags of the training CLIs and ``--model``, ``--epoch_samples``,
    ``--ema_teacher``."""
    p = train_parser()
    p.add_argument("--model", type=str, default="ssftt",
                   choices=sorted(ZOO.keys()))
    p.add_argument("--epoch_samples", type=int, default=None,
                   help="tile the labeled split to this many samples/epoch")
    p.add_argument("--ema_teacher", type=float, default=0.0,
                   help="EMA-teacher decay alpha (e.g. 0.95): keep an "
                        "exponential-moving-average copy of the weights "
                        "and map it too (reference WeightEMA_BN, "
                        "tools/models.py:155-164)")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    setup_runtime(args)
    device = resolve_device(args.device)
    mesh = create_mesh(device)
    entry = ZOO[args.model]
    w, n_pc = entry_shape(args, entry, get_dataset(args.dataID))
    spec, scene, splits = build_scene(args, device, patch_size=w, n_pc=n_pc)

    trainer = SupervisedTrainer(
        args.model, spec, lr=args.lr, patch_size=w, n_pc=n_pc,
        augment=bool(args.augment), gather_impl=args.gather_impl,
        ema_alpha=args.ema_teacher, device=device, mesh=mesh)
    # the trainer rounds it to a multiple of the ranks
    bs = min(args.labeled_batch_size, len(splits.train))
    state, start_epoch = maybe_resume(
        args, trainer, trainer.init_state(args.seed),
        trainer.steps_per_epoch(len(splits.train), bs, args.epoch_samples))
    sync(device)
    t0 = time.perf_counter()
    state, history = trainer.fit(
        state, scene, splits.train, scene.labels, batch_size=bs,
        num_epochs=args.num_epochs, epoch_samples=args.epoch_samples,
        log_every=args.print_per_batches, start_epoch=start_epoch,
        on_epoch_end=make_epoch_hook(args, trainer))
    sync(device)
    print(f"training time == {time.perf_counter() - t0:.3f}s "
          f"({len(history)} steps)")
    save_history(args, history)

    y_test = scene.labels[splits.test] - 1
    spectra = entry.inputs == "dual"
    results = []
    for ema, name in ((False, args.model),
                      (True, f"{args.model} EMA teacher")):
        if ema and args.ema_teacher <= 0:
            continue
        model = trainer.eval_model(state, ema=ema)
        pred = scene_map(args, scene, trainer.logits_fn(model),
                         trainer.eval_variables(state, ema=ema), name,
                         spectra=spectra, mesh=mesh)
        acc = cal_accuracy(pred[splits.test], y_test)
        report_accuracy(name, acc)
        results.append((pred, acc))

    pred, acc = results[0]
    if is_primary():
        out = save_path(args, spec)
        save_class_map(
            os.path.join(out, f"{args.model}_OA_{int(acc.oa * 10000)}.svg"),
            pred + 1, spec, rows=scene.rows, cols=scene.cols)
        save_report(os.path.join(out, f"{args.model}_results.csv"), [acc])
    save_final_checkpoint(args, trainer, state)
    if args.weights_out and is_primary():
        save_params_npz(args.weights_out, zoo_variables_to_jax(
            args.model, state.model.state_dict()))
        print(f"wrote {args.weights_out}")
    return acc


if __name__ == "__main__":
    run_resilient(main)
