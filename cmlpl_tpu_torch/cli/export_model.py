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
device.  The whole training run as a bundle (``--train_bundle``,
``--import_run``) is not ported yet (ROADMAP item 11b); the flags are
refused.
"""

from __future__ import annotations

import os
import time

import torch

from cmlpl_tpu_torch.cli._common import (base_parser, build_model, logits_fn,
                                         sync)
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.device import resolve_device
from cmlpl_tpu_torch.eval.inference import ScenePredictor
from cmlpl_tpu_torch.registry import get_dataset
from cmlpl_tpu_torch.utils.export import (EXPORT_GATHERS, build_exported,
                                          load_exported, save_exported,
                                          save_native_bundle, serialize)

PLATFORMS = ("cuda", "cpu")


def _platform(args) -> str:
    """The one export platform: ``--platform``, else ``--device``'s type."""
    if not args.platform:
        return torch.device(args.device).type
    if len(args.platform) > 1:
        raise SystemExit(
            f"--platform takes one platform, got {args.platform}: a "
            "torch.export program holds its weights on one device")
    if args.platform[0] not in PLATFORMS:
        raise SystemExit(f"--platform {args.platform[0]!r} is not one of "
                         f"{PLATFORMS}")
    return args.platform[0]


def main(argv=None):
    p = base_parser()
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
                   help="not ported yet (ROADMAP item 11b): refused")
    p.add_argument("--import_run", nargs=2, default=None,
                   metavar=("BUNDLE", "OUTDIR"),
                   help="not ported yet (ROADMAP item 11b): refused")
    args = p.parse_args(argv)
    for flag in ("train_bundle", "import_run"):
        if getattr(args, flag):
            raise SystemExit(
                f"--{flag} is not ported yet: the training-run bundle is "
                "ROADMAP item 11b; this CLI exports the whole-scene "
                "predictor only")
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
