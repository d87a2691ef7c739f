"""CMLPL training CLI (``cmlpl_tpu/cli/train.py``, reference ``train.py``):
semi-supervised dual-network training, full-scene maps of both nets,
OA/AA/Kappa report, class map, CSV.

    python -m cmlpl_tpu_torch.cli.train --dataID 1 --weights_out w.npz

Runs on the CUDA card unless ``--device cpu``.  ``--num_iters`` repeats
the run serially with seeds ``(--seed, iteration)`` and reports mean ± std;
``--resume`` applies to the first, and ``--profile_dir`` traces the first
(``utils/profiling.trace``).  With ``--fused_iters`` the runs are one step
loop over seed-stacked states (``EpochDriver.train_multi_run``), the
serial loop's results within rounding; it refuses ``--resume``,
``--profile_dir`` and ``--checkpoint_every`` as the JAX CLI does.
``--weights_out`` writes net B's params (of the last run) as the
JAX-layout npz that predict and serve read; ``--checkpoint_dir`` the
trainer state.  Run as a module, a failed run is retried up to
``--max_restarts`` times from its latest checkpoint.

``--multihost`` under ``torchrun`` (one process a card) trains data
parallel over the ranks and maps each net with one strip of tiles a rank
(``core/mesh.py``); every rank prints the OAs and rank 0 writes the
files.  With ``--fused_iters`` the seeds are split over the ranks when
they divide them (else every rank trains every seed): each rank maps its
own seeds, the maps are gathered for the report, and the last seed's
state, on the last rank, is placed on every rank for ``--weights_out``
and ``--checkpoint_dir``.

    python -m torch.distributed.run --nproc_per_node 2 \
        -m cmlpl_tpu_torch.cli.train --multihost --dataID 1
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from cmlpl_tpu_torch.cli._common import (build_config, build_data,
                                         is_primary, logits_fn,
                                         make_epoch_hook, maybe_resume,
                                         report_accuracy, run_resilient,
                                         save_final_checkpoint, save_history,
                                         save_path, scene_map, setup_runtime,
                                         sync, timed_fit, train_parser)
from cmlpl_tpu_torch.core.mesh import create_mesh, gather_rows, place_state
from cmlpl_tpu_torch.device import resolve_device
from cmlpl_tpu_torch.eval.metrics import cal_accuracy
from cmlpl_tpu_torch.eval.report import save_report
from cmlpl_tpu_torch.eval.visualize import save_class_map
from cmlpl_tpu_torch.train.cmlpl import CMLPLTrainer
from cmlpl_tpu_torch.utils.profiling import trace
from cmlpl_tpu_torch.weights import params_to_jax, save_params_npz


def main(argv=None):
    args = train_parser().parse_args(argv)
    setup_runtime(args)
    device = resolve_device(args.device)
    mesh = create_mesh(device)
    spec, scene, splits, sampler = build_data(args, device)
    cfg = build_config(args, spec)
    trainer = CMLPLTrainer(cfg, device=device, mesh=mesh)
    y_test = scene.labels[splits.test] - 1
    out = save_path(args, spec)

    def net_map(net, name, mesh=mesh):
        net.model.eval()
        return scene_map(args, scene, logits_fn(net.model),
                         net.model.state_dict(), name, mesh=mesh)

    runs_b, runs_e = [], []

    def report(pred_b, pred_e):
        acc_b = cal_accuracy(pred_b[splits.test], y_test)
        acc_e = cal_accuracy(pred_e[splits.test], y_test)
        report_accuracy("net B", acc_b)
        report_accuracy("net E", acc_e)
        runs_b.append(acc_b)
        runs_e.append(acc_e)
        if is_primary():
            save_class_map(
                os.path.join(out, f"CMLPL_OA_{int(acc_b.oa * 10000)}.svg"),
                pred_b + 1, spec, rows=scene.rows, cols=scene.cols)

    if args.fused_iters and args.num_iters > 1:
        if args.resume or args.profile_dir or args.checkpoint_every:
            raise SystemExit("--fused_iters is incompatible with "
                             "--resume/--profile_dir/--checkpoint_every")
        sync(device)
        t0 = time.perf_counter()
        states, metrics = trainer.train_multi_run(args.seed, scene, sampler,
                                                  args.num_iters)
        sync(device)
        print(f"fused {args.num_iters}-seed training time == "
              f"{time.perf_counter() - t0:.3f}s")
        # seed 0's history (rank 0's first seed), as the serial loop saves
        # the first run's
        m0 = {k: v[0].reshape(-1).tolist() for k, v in metrics.items()}
        save_history(args, [dict(zip(m0, s)) for s in zip(*m0.values())])
        # each rank maps its own seeds whole; a split run's maps are
        # gathered, seed-major, for the report
        lo, hi = trainer.seed_block(args.num_iters)
        maps = torch.from_numpy(np.stack([
            np.stack([net_map(st.net_b, "net B", None),
                      net_map(st.net_e, "net E", None)])
            for st in states])).to(device)
        if hi - lo < args.num_iters:
            maps = gather_rows(maps, mesh, lo, args.num_iters)
        for pred_b, pred_e in maps.cpu().numpy():
            report(pred_b, pred_e)
        # the last seed's state, on the last rank, on every rank
        state = place_state(mesh, trainer, states[-1],
                            src=mesh.size - 1 if hi - lo < args.num_iters
                            else 0)
    else:
        for index_iter in range(args.num_iters):
            state = trainer.init_state((args.seed, index_iter))
            start_epoch = 0
            profile = None
            if index_iter == 0:
                state, start_epoch = maybe_resume(args, trainer, state,
                                                  sampler.batches_per_epoch)
                profile = args.profile_dir
            with trace(profile) if profile else contextlib.nullcontext():
                state, history = timed_fit(trainer, state, scene, sampler,
                                           args.print_per_batches,
                                           start_epoch,
                                           make_epoch_hook(args, trainer))
            if index_iter == 0:
                save_history(args, history)
            report(net_map(state.net_b, "net B"), net_map(state.net_e,
                                                          "net E"))

    if is_primary():
        save_report(os.path.join(out, "cmlpl_results.csv"), runs_b, runs_e)
    if args.num_iters > 1:
        oas = np.array([r.oa for r in runs_b])
        print(f"mean_OA ± std_OA is: {oas.mean()} ± {oas.std()}")
    save_final_checkpoint(args, trainer, state)
    if args.weights_out and is_primary():
        save_params_npz(args.weights_out,
                        params_to_jax(state.net_b.model.state_dict()))
        print(f"wrote {args.weights_out}")
    return runs_b[-1], runs_e[-1]


if __name__ == "__main__":
    run_resilient(main)
