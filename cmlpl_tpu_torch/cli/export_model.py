"""Export a trained BaseNet2 as a standalone whole-scene predictor.

    python -m cmlpl_tpu_torch.cli.export_model --dataID 1 \
        --checkpoint_dir ./ckpt --out paviau.cmlpl.zip [--eval_gather dense] \
        [--verify] [--native_dir bundle/]

Counterpart of ``cmlpl_tpu/cli/export_model.py:91-175``.  The artifact
(see :mod:`cmlpl_tpu_torch.utils.export`) holds the trained weights and
the whole-scene predictor for the dataset's geometry as a
``torch.export`` program; any Python with torch maps scenes with

    from cmlpl_tpu_torch.utils.export import load_exported
    meta, fn = load_exported("paviau.cmlpl.zip")
    labels = fn(padded_cube, spectra)

without the model code or the checkpoint format.  ``--verify`` reloads the
artifact and holds its map to the in-process predictor's
(``ScenePredictor`` with ``--eval_gather``: under ``auto`` on the card,
the f32 CUDA gather kernel).  ``--native_dir`` also writes the native
runner's bundle, an AOTInductor package (``native/aoti_host.cpp``).

The model is net ``--net`` of the latest checkpoint of
``--checkpoint_dir`` or ``--weights``, exactly one of the two.  An
artifact is for one platform, ``--platform cuda`` or ``cpu`` (default:
``--device``'s): a ``torch.export`` program holds its weights on one
device.

The training run as a bundle (``cmlpl_tpu/cli/export_model.py:37-90``):

    python -m cmlpl_tpu_torch.cli.export_model --dataID 1 \
        --train_bundle DIR                      # + cli.train's flags
    aoti_host --bundle DIR --inputs DIR/inputs --outdir OUT
    python -m cmlpl_tpu_torch.cli.export_model --dataID 1 \
        --import_run DIR OUT --checkpoint_dir CK    # the same flags

``--train_bundle`` writes the whole CMLPL run at the training flags as one
AOTInductor package with its inputs (``utils/export.build_run_exported``,
``save_run_bundle``): the initial state of ``cli.train``'s serial run 0
for ``--seed``, the scene, the pool and the schedule.  Under a per-step
``--gather_impl`` (``xla``, ``pallas``, ``pallas_bf16``, or ``auto``
over the pool's budget) the program has no pool and gathers each step at
its pixel ids, inside the program: by the plain gather, or by kernel 1 or
2 as the operator ``cmlpl::gather_patches_f32`` or ``_bf16``, which the
runner loads from the operators' library (``--op_library``; a kernel
mode's bundle is for ``--platform cuda`` only).  ``--import_run``
turns a run's outputs into ``<CK>/<step>/state.npz``, from which
``predict``/``serve --checkpoint_dir`` map; the checkpoint has no
``generator.npy`` (a restore seeds the generator as ``state_from_jax``
does).  A run program replays one serial run, ``--extra_loss memobank``
included (its bank is ``state.bank.*``, in the checkpoint ``bank/*``):
``--fused_iters`` is refused.
"""

from __future__ import annotations

import os
import time

from cmlpl_tpu_torch.cli._common import (build_config, build_data,
                                         build_model, export_parser,
                                         is_primary, logits_fn,
                                         setup_runtime, sync)
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.device import resolve_device
from cmlpl_tpu_torch.eval.inference import ScenePredictor
from cmlpl_tpu_torch.registry import get_dataset
from cmlpl_tpu_torch.train.cmlpl import CMLPLTrainer
from cmlpl_tpu_torch.utils.checkpoint import save_checkpoint
from cmlpl_tpu_torch.utils.export import (EXPORT_GATHERS, build_exported,
                                          build_run_exported,
                                          load_exported, load_run_outputs,
                                          save_exported, save_native_bundle,
                                          save_run_bundle, serialize)

PLATFORMS = ("cuda", "cpu")


def _platform(args) -> str:
    """The one export platform: ``--platform``, else ``--device``'s type."""
    if not args.platform:
        return resolve_device(args.device).type
    if len(args.platform) > 1:
        raise SystemExit(
            f"--platform takes one platform, got {args.platform}: a "
            "torch.export program holds its weights on one device")
    if args.platform[0] not in PLATFORMS:
        raise SystemExit(f"--platform {args.platform[0]!r} is not one of "
                         f"{PLATFORMS}")
    return args.platform[0]


def _export_train_bundle(args) -> str:
    """--train_bundle: the whole CMLPL run at the training flags, the
    initial state and schedule those of ``cli.train``'s serial run 0."""
    if args.fused_iters:
        raise SystemExit("--train_bundle exports one serial run; "
                         "--fused_iters has no run program")
    platform = _platform(args)
    device = resolve_device(platform)
    spec, scene, _, sampler = build_data(args, device)
    trainer = CMLPLTrainer(build_config(args, spec), device=device)
    t0 = time.perf_counter()
    meta, exported, inputs = build_run_exported(
        trainer, scene, sampler, (args.seed, 0), platform=platform)
    export_s = time.perf_counter() - t0
    meta.update({"dataset": spec.name, "dataID": spec.data_id,
                 "seed": args.seed})
    t0 = time.perf_counter()
    package = save_run_bundle(args.train_bundle, meta, exported, inputs)
    compile_s = time.perf_counter() - t0
    n_bytes = sum(v.nbytes for v in inputs.values())
    print(f"train bundle -> {args.train_bundle}: "
          f"{os.path.getsize(package) / 1e6:.2f} MB AOTInductor package, "
          f"{len(inputs)} inputs ({n_bytes / 1e6:.1f} MB), "
          f"{len(meta['output_names'])} outputs, "
          f"platforms={meta['platforms']} export_s={export_s:.3f} "
          f"aoti_compile_s={compile_s:.3f} "
          f"gather_impl={meta['gather_impl']} "
          f"custom_ops={','.join(meta['custom_ops']) or '-'}")
    return args.train_bundle


def _import_run(args) -> str:
    """--import_run: a run's outputs -> ``<checkpoint_dir>/<step>/``.  The
    training flags must be the bundle's, so the state's shapes line up.
    Nothing is computed: the state is built on the CPU."""
    if not args.checkpoint_dir:
        raise SystemExit("--import_run needs --checkpoint_dir")
    bundle, outdir = args.import_run
    spec = get_dataset(args.dataID)
    trainer = CMLPLTrainer(build_config(args, spec), device="cpu")
    state, metrics = load_run_outputs(bundle, outdir, trainer)
    if is_primary():
        save_checkpoint(args.checkpoint_dir, trainer, state, generator=False)
    tail = {k: float(v.reshape(-1)[-1]) for k, v in metrics.items()}
    print(f"imported native run -> {args.checkpoint_dir} "
          f"(step {state.step}); final metrics: "
          + " ".join(f"{k}={v:.4f}" for k, v in sorted(tail.items())))
    return args.checkpoint_dir


def main(argv=None):
    p = export_parser()
    p.add_argument("--out", type=str, default="model.cmlpl.zip")
    p.add_argument("--platform", nargs="*", default=None,
                   help="the artifact's platform, cuda or cpu (one; "
                        "default: --device's)")
    p.add_argument("--verify", action="store_true",
                   help="reload the artifact and compare its map with the "
                        "in-process predictor's")
    p.add_argument("--native_dir", type=str, default=None,
                   help="also write the native runner's bundle here "
                        "(model.pt2, an AOTInductor package, + "
                        "signature.txt + meta.json) for "
                        "native/aoti_host.cpp")
    p.add_argument("--train_bundle", type=str, default=None,
                   help="instead of a predictor, export the WHOLE CMLPL "
                        "training run at the training flags into this dir "
                        "(model.pt2 + signature.txt + meta.json + "
                        "inputs/*.npy: init state, scene, the pool or, "
                        "under a per-step --gather_impl, none, schedule); "
                        "the runner then trains with no Python: aoti_host "
                        "--bundle DIR --inputs DIR/inputs --outdir OUT "
                        "[--op_library LIB, for a kernel --gather_impl]")
    p.add_argument("--import_run", nargs=2, default=None,
                   metavar=("BUNDLE", "OUTDIR"),
                   help="import a runner's training outputs (aoti_host "
                        "--inputs BUNDLE/inputs --outdir OUTDIR) into a "
                        "checkpoint at --checkpoint_dir, which predict and "
                        "serve read; pass the flags used at export")
    args = p.parse_args(argv)
    setup_runtime(args)
    if args.import_run:
        return _import_run(args)
    if args.train_bundle:
        return _export_train_bundle(args)
    gather = "xla" if args.eval_gather == "auto" else args.eval_gather
    if gather not in EXPORT_GATHERS:
        raise SystemExit(
            f"--eval_gather {args.eval_gather} cannot be exported (the CUDA "
            "kernel modes are ctypes launches, which torch.export cannot "
            f"capture); use one of {EXPORT_GATHERS} or auto")
    platform = _platform(args)
    export_device = resolve_device(platform)
    device = resolve_device(args.device)

    spec = get_dataset(args.dataID)
    scene = prepare_scene(spec, root=args.data_root, patch_size=args.w,
                          n_pc=args.n_PC, device=device)
    model = build_model(args, spec, device)
    t0 = time.perf_counter()
    meta, exported = build_exported(
        model, model.state_dict(), scene, gather=gather,
        tile=args.val_batch_size, device=export_device,
        extra_meta={"dataset": spec.name, "dataID": spec.data_id,
                    "net": args.net})
    payload = serialize(exported)
    save_exported(args.out, meta, payload)
    print(f"exported {args.out}: {len(payload) / 1e6:.2f} MB, "
          f"platforms={meta['platforms']}, gather={meta['gather']}, "
          f"compute_dtype={meta['compute_dtype']} in "
          f"{time.perf_counter() - t0:.3f}s")
    if args.native_dir:
        t0 = time.perf_counter()
        package = save_native_bundle(args.native_dir, meta, exported)
        print(f"native bundle -> {args.native_dir} (model.pt2 "
              f"{os.path.getsize(package) / 1e6:.2f} MB) compiled in "
              f"{time.perf_counter() - t0:.3f}s")

    if args.verify:
        _, fn = load_exported(args.out)
        inputs = (scene.padded_pca.to(export_device),
                  scene.spectra.to(export_device))
        sync(export_device)
        t0 = time.perf_counter()
        preds = fn(*inputs)
        print(f"artifact inference time == {time.perf_counter() - t0:.3f}s")
        ref = ScenePredictor(logits_fn(model), params=model.state_dict(),
                             patch_size=scene.patch_size, cols=scene.cols,
                             tile=args.val_batch_size,
                             gather=args.eval_gather)(scene)
        agree = float((preds == ref).mean())
        print(f"agreement vs in-process predictor: {agree:.5f}")
        if agree < 1.0:
            raise SystemExit("verification FAILED")
    return args.out


if __name__ == "__main__":
    main()
