"""CCT training CLI (``cmlpl_tpu/cli/train_cct.py``, reference
``trian_CCT.py``): cross-consistency training of one encoder and three
heads, the full-scene map through the encoder and ``dec_base``,
OA/AA/Kappa report, class map, CSV.

    python -m cmlpl_tpu_torch.cli.train_cct --dataID 1 --weights_out cct.npz

Runs on the CUDA card unless ``--device cpu``.  ``--weights_out`` writes
the CCT param tree (``encoder``, ``dec_base``, ``dec1``, ``dec2``) as a
flat JAX-layout npz.  It accepts and ignores ``--num_iters``, as the JAX
CLI does.  ``--checkpoint_dir``, ``--resume``, ``--max_restarts`` and
``--multihost`` work as in ``cli.train``.
"""

from __future__ import annotations

import os

from cmlpl_tpu_torch.cli._common import (build_config, build_data,
                                         is_primary, make_epoch_hook,
                                         maybe_resume, report_accuracy,
                                         run_resilient,
                                         save_final_checkpoint, save_history,
                                         save_path, scene_map, setup_runtime,
                                         timed_fit, train_parser)
from cmlpl_tpu_torch.core.mesh import create_mesh
from cmlpl_tpu_torch.device import resolve_device
from cmlpl_tpu_torch.eval.metrics import cal_accuracy
from cmlpl_tpu_torch.eval.report import save_report
from cmlpl_tpu_torch.eval.visualize import save_class_map
from cmlpl_tpu_torch.train.cct import CCTTrainer, cct_logits_fn
from cmlpl_tpu_torch.weights import params_to_jax, save_params_npz


def main(argv=None):
    args = train_parser().parse_args(argv)
    setup_runtime(args)
    device = resolve_device(args.device)
    mesh = create_mesh(device)
    spec, scene, splits, sampler = build_data(args, device)
    trainer = CCTTrainer(build_config(args, spec), device=device, mesh=mesh)
    state, start_epoch = maybe_resume(args, trainer,
                                      trainer.init_state(args.seed),
                                      sampler.batches_per_epoch)
    state, history = timed_fit(trainer, state, scene, sampler,
                               args.print_per_batches, start_epoch,
                               make_epoch_hook(args, trainer))
    save_history(args, history)

    model = state.model.eval()
    pred = scene_map(args, scene, cct_logits_fn(model), model.state_dict(),
                     "CCT", mesh=mesh)
    acc = cal_accuracy(pred[splits.test], scene.labels[splits.test] - 1)
    report_accuracy("CCT", acc)

    if is_primary():
        out = save_path(args, spec)
        save_class_map(
            os.path.join(out, f"CCT_OA_{int(acc.oa * 10000)}.svg"),
            pred + 1, spec, rows=scene.rows, cols=scene.cols)
        save_report(os.path.join(out, "cct_results.csv"), [acc])
    save_final_checkpoint(args, trainer, state)
    if args.weights_out and is_primary():
        save_params_npz(args.weights_out, params_to_jax(model.state_dict()))
        print(f"wrote {args.weights_out}")
    return acc


if __name__ == "__main__":
    run_resilient(main)
