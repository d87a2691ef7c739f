"""Shared CLI plumbing for the port's predict and serve entry points.

The flags are the subset of ``cmlpl_tpu/cli/_common.py::base_parser``
that predict and serve read, with the same names and defaults, plus
``--device`` and ``--weights``.  ``--weights`` names a BaseNet2 param npz
in the JAX layout (:mod:`cmlpl_tpu_torch.weights`); it takes the place of
``--checkpoint_dir``, whose orbax checkpoints need JAX to read.
"""

from __future__ import annotations

import argparse

import numpy as np

from cmlpl_tpu_torch.eval.inference import GATHERS
from cmlpl_tpu_torch.models.basenet import BaseNet2
from cmlpl_tpu_torch.weights import (basenet2_state_dict_from_jax,
                                     load_params_npz)


def base_parser() -> argparse.ArgumentParser:
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
                   help="model compute dtype (params stay float32)")
    p.add_argument("--eval_gather", type=str, default="auto",
                   choices=list(GATHERS) + ["dense"],
                   help="full-scene inference patch gather: auto = the f32 "
                        "CUDA kernel on the card / the plain gather on the "
                        "CPU; pallas = the f32 CUDA kernel; pallas_bf16 = "
                        "the bf16 CUDA kernel (patch inputs "
                        "bf16-quantised); xla = the plain PyTorch gather; "
                        "dense is not ported yet")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CPU only when asked for")
    p.add_argument("--weights", type=str, default=None,
                   help="BaseNet2 params as a flat '<layer>/<leaf>' npz in "
                        "the JAX layout (replaces --checkpoint_dir)")
    return p


def build_model(args, spec, device) -> BaseNet2:
    """BaseNet2 for ``spec`` with the ``--weights`` params, in eval mode."""
    if not args.weights:
        raise SystemExit("--weights is required")
    model = BaseNet2(num_features=spec.num_bands, dropout=args.dropout,
                     num_classes=spec.num_classes, n_pc=args.n_PC,
                     patch_size=args.w, compute_dtype=args.compute_dtype)
    model.load_state_dict(
        basenet2_state_dict_from_jax(load_params_npz(args.weights)))
    return model.to(device).eval()


def logits_fn(model: BaseNet2):
    """``(xp, x) -> logits`` of a BaseNet2, for ``ScenePredictor``."""
    return lambda xp, x: model(xp, x)[0]


def report_accuracy(name: str, acc) -> None:
    print(f"Result ({name}):\n OA={acc.oa * 100:.2f}, "
          f"Kappa={acc.kappa * 100:.2f}")
    print("producerA:", np.array2string(acc.producer * 100, precision=2))
    print(f"AA={acc.aa * 100:.2f}")
