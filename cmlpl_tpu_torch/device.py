"""Device and numeric-precision selection.

The port runs on the CUDA card unless the caller asks for the CPU: there
is no silent CPU fallback when CUDA is missing.
"""

from __future__ import annotations

import contextlib
import os

import torch


def resolve_device(name=None) -> torch.device:
    """``None`` or an index-less ``"cuda"`` -> the rank's card,
    ``cuda:LOCAL_RANK``, inside a world of more than one process
    (``torchrun``'s ``WORLD_SIZE``), else the current CUDA device;
    ``"cpu"``, ``"cuda:<i>"`` or any other explicit device is taken as
    given.  A CUDA device raises if CUDA is absent."""
    dev = torch.device("cuda" if name is None else name)
    if (dev.type == "cuda" and dev.index is None
            and int(os.environ.get("WORLD_SIZE", "1")) > 1):
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU")
    return dev


@contextlib.contextmanager
def compute_precision(compute_dtype: str):
    """TF32 for cuDNN convolutions and cuBLAS matmuls, set from a compute
    dtype for the calls inside the block and restored on exit.

    cuDNN defaults to TF32 for f32 convs, so ``float32`` turns both off to
    keep f32 meaning f32; under ``bfloat16`` the layers compute in bf16
    and TF32 is allowed.  The switches are process-global, so a model
    scopes them to its own calls: building or running one leaves every
    later call as it found it.

    While Dynamo traces (the body of a loop operator that ``torch.export``
    captures), the block sets nothing: no op of a graph records the
    switches, so whoever traces or runs the graph sets them around it
    (``utils/export.py``)."""
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    if torch.compiler.is_dynamo_compiling():
        yield
        return
    tf32 = compute_dtype == "bfloat16"
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
