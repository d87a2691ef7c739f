"""CPS training CLI (``cmlpl_tpu/cli/train_cps.py``, reference
``trian_CPS.py``): cross-pseudo-supervision training of two BaseNet2s,
full-scene maps of both nets, OA/AA/Kappa report, class map of net B, CSV
of both.

    python -m cmlpl_tpu_torch.cli.train_cps --dataID 1 --weights_out w.npz

Runs on the CUDA card unless ``--device cpu``.  ``--weights_out`` writes
net B's params as the JAX-layout npz that predict and serve read.  It
accepts and ignores ``--num_iters``, as the JAX CLI does.
``--checkpoint_dir``, ``--resume``, ``--max_restarts`` and
``--multihost`` work as in ``cli.train``.
"""

from __future__ import annotations

import os

from cmlpl_tpu_torch.cli._common import (build_config, build_data,
                                         is_primary, logits_fn,
                                         make_epoch_hook, maybe_resume,
                                         report_accuracy, run_resilient,
                                         save_final_checkpoint, save_history,
                                         save_path, scene_map, setup_runtime,
                                         timed_fit, train_parser)
from cmlpl_tpu_torch.core.mesh import create_mesh
from cmlpl_tpu_torch.device import resolve_device
from cmlpl_tpu_torch.eval.metrics import cal_accuracy
from cmlpl_tpu_torch.eval.report import save_report
from cmlpl_tpu_torch.eval.visualize import save_class_map
from cmlpl_tpu_torch.train.cps import CPSTrainer
from cmlpl_tpu_torch.weights import params_to_jax, save_params_npz


def main(argv=None):
    args = train_parser().parse_args(argv)
    setup_runtime(args)
    device = resolve_device(args.device)
    mesh = create_mesh(device)
    spec, scene, splits, sampler = build_data(args, device)
    trainer = CPSTrainer(build_config(args, spec), device=device, mesh=mesh)
    state, start_epoch = maybe_resume(args, trainer,
                                      trainer.init_state(args.seed),
                                      sampler.batches_per_epoch)
    state, history = timed_fit(trainer, state, scene, sampler,
                               args.print_per_batches, start_epoch,
                               make_epoch_hook(args, trainer))
    save_history(args, history)

    preds = {}
    for name, net in (("net B", state.net_b), ("net E", state.net_e)):
        net.model.eval()
        preds[name] = scene_map(args, scene, logits_fn(net.model),
                                net.model.state_dict(), name, mesh=mesh)
    y_test = scene.labels[splits.test] - 1
    acc_b = cal_accuracy(preds["net B"][splits.test], y_test)
    acc_e = cal_accuracy(preds["net E"][splits.test], y_test)
    report_accuracy("net B", acc_b)
    report_accuracy("net E", acc_e)

    if is_primary():
        out = save_path(args, spec)
        save_class_map(
            os.path.join(out, f"CPS_OA_{int(acc_b.oa * 10000)}.svg"),
            preds["net B"] + 1, spec, rows=scene.rows, cols=scene.cols)
        save_report(os.path.join(out, "cps_results.csv"), [acc_b], [acc_e])
    save_final_checkpoint(args, trainer, state)
    if args.weights_out and is_primary():
        save_params_npz(args.weights_out,
                        params_to_jax(state.net_b.model.state_dict()))
        print(f"wrote {args.weights_out}")
    return acc_b, acc_e


if __name__ == "__main__":
    run_resilient(main)
