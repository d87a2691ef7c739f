"""CMLPL training CLI (``cmlpl_tpu/cli/train.py``, reference ``train.py``):
semi-supervised dual-network training, full-scene maps of both nets,
OA/AA/Kappa report, class map, CSV.

    python -m cmlpl_tpu_torch.cli.train --dataID 1 --weights_out w.npz

Runs on the CUDA card unless ``--device cpu``.  ``--num_iters`` repeats
the run serially with seeds ``(--seed, iteration)`` and reports mean ± std.
``--weights_out`` writes net B's params as the JAX-layout npz that predict
and serve read; checkpoints, resume, ``--fused_iters``, ``--multihost``
and ``--profile_dir`` are not ported yet (ROADMAP.md section 1).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from cmlpl_tpu_torch.cli._common import (build_config, build_data,
                                         logits_fn, report_accuracy,
                                         save_history, save_path,
                                         train_parser)
from cmlpl_tpu_torch.device import resolve_device
from cmlpl_tpu_torch.eval.inference import ScenePredictor
from cmlpl_tpu_torch.eval.metrics import cal_accuracy
from cmlpl_tpu_torch.eval.report import save_report
from cmlpl_tpu_torch.eval.visualize import save_class_map
from cmlpl_tpu_torch.train.cmlpl import CMLPLTrainer
from cmlpl_tpu_torch.weights import basenet2_params_to_jax, save_params_npz


def main(argv=None):
    args = train_parser().parse_args(argv)
    device = resolve_device(args.device)
    spec, scene, splits, sampler = build_data(args, device)
    cfg = build_config(args, spec)
    trainer = CMLPLTrainer(cfg, device=device)
    y_test = scene.labels[splits.test] - 1
    out = save_path(args, spec)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def scene_map(model, name):
        model.eval()
        predictor = ScenePredictor(logits_fn(model),
                                   patch_size=cfg.patch_size,
                                   cols=scene.cols, tile=cfg.val_batch,
                                   gather=args.eval_gather)
        t0 = time.perf_counter()
        pred = predictor(scene)
        print(f"full-scene inference time ({name}) == "
              f"{time.perf_counter() - t0:.3f}s")
        return pred

    runs_b, runs_e = [], []
    state = None
    for index_iter in range(args.num_iters):
        state = trainer.init_state((args.seed, index_iter))
        sync()
        t0 = time.perf_counter()
        state, history = trainer.fit(state, scene, sampler,
                                     log_every=args.print_per_batches)
        sync()
        print(f"training time == {time.perf_counter() - t0:.3f}s "
              f"({len(history)} steps)")
        if index_iter == 0:
            save_history(args, history)

        pred_b = scene_map(state.net_b.model, "net B")
        pred_e = scene_map(state.net_e.model, "net E")
        acc_b = cal_accuracy(pred_b[splits.test], y_test)
        acc_e = cal_accuracy(pred_e[splits.test], y_test)
        report_accuracy("net B", acc_b)
        report_accuracy("net E", acc_e)
        runs_b.append(acc_b)
        runs_e.append(acc_e)
        save_class_map(
            os.path.join(out, f"CMLPL_OA_{int(acc_b.oa * 10000)}.svg"),
            pred_b + 1, spec, rows=scene.rows, cols=scene.cols)

    save_report(os.path.join(out, "cmlpl_results.csv"), runs_b, runs_e)
    if args.num_iters > 1:
        oas = np.array([r.oa for r in runs_b])
        print(f"mean_OA ± std_OA is: {oas.mean()} ± {oas.std()}")
    if args.weights_out:
        save_params_npz(args.weights_out,
                        basenet2_params_to_jax(state.net_b.model.state_dict()))
        print(f"wrote {args.weights_out}")
    return runs_b[-1], runs_e[-1]


if __name__ == "__main__":
    main()
