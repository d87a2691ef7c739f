"""Windowed patch gather: the CUDA kernels, their wrappers and the plain
PyTorch version they are held against.

For flat pixel ids ``idx`` (B,) int32 over a scene of ``cols`` columns,
every function here returns

    out[b] = cube[r:r+w, c:c+w, :],   r = idx[b] // cols,  c = idx[b] % cols

as a contiguous (B, w, w, C) tensor of the cube's dtype, with the start
clamped into the cube the way ``lax.dynamic_slice`` clamps it (the
contract of ``cmlpl_tpu.data.patches.gather_patches``).

Kernel 1, :func:`gather_patches_f32`, replaces the Pallas TPU kernel
``cmlpl_tpu/ops/patch_gather.py::gather_patches_pallas`` (f32).  Kernel 2,
:func:`gather_patches_bf16`, replaces ``gather_patches_pallas_shifted``
(bf16) and reads a plain bf16 cube (``padded.to(torch.bfloat16)``) where
the TPU kernel needed eight column-shifted copies.  Both are one templated
CUDA source, ``csrc/patch_gather.cu``, with two paths that
:func:`gather_plan` chooses by shape: a block per patch row for wide rows,
and for narrow ones blocks of whole patches with a warp per patch row,
aligned 16-byte reads and writes whatever the pixel stride.  Its header
says what bounds it (bytes: the (B, w, w, C) output is written once, the
overlapping window reads mostly hit L2; at the callers' sizes, latency)
and what its design does about it.

A wrapper given CPU tensors runs the plain version,
:func:`cmlpl_tpu_torch.data.patches.gather_patches`.  Given CUDA
tensors it launches its kernel or raises: it never falls back to the plain
version.  ``<wrapper>.launches`` counts the kernel launches.

Each wrapper is also an operator, ``cmlpl::gather_patches_f32`` and
``cmlpl::gather_patches_bf16`` (:data:`OP_SCHEMAS`), with the same
contract and a fake kernel, so that a traced training step holds a kernel
gather as one node and an exported run program carries it; the per-step
training gathers call them.  ``csrc/gather_ops.cpp`` registers the same
schemas in C++ for the native runner, which has no Python.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from cmlpl_tpu_torch.data.patches import gather_patches as gather_patches_plain
from cmlpl_tpu_torch.ops import _build


def _check(cube: torch.Tensor, idx: torch.Tensor, cols: int, w: int,
           dtype: torch.dtype) -> None:
    if cube.dtype != dtype:
        raise TypeError(f"cube must be {dtype}, got {cube.dtype}")
    if cube.dim() != 3:
        raise ValueError(f"cube must be (rows, cols, C), got {cube.shape}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError(f"idx must be a 1-D int32 tensor, got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if idx.device != cube.device:
        raise ValueError(f"idx on {idx.device}, cube on {cube.device}")
    if not (0 < w <= min(cube.shape[0], cube.shape[1])):
        raise ValueError(f"window {w} does not fit cube {tuple(cube.shape)}")
    if cols <= 0:
        raise ValueError(f"cols must be positive, got {cols}")


#: the kernel's paths (the C entry points' ``path`` argument): a block per
#: patch row, or blocks of G whole patches with R patch rows a warp
PATH_ROWS, PATH_GROUPS = 0, 1
#: the rows path: one block of this many threads per (patch, patch row)
ROW_THREADS = 128
#: rows of at least this many bytes, with pixels of a multiple of 8 bytes,
#: take the rows path: a block per row then moves kilobytes, mostly in 16-
#: and 8-byte copies
ROWS_MIN_BYTES = 2048
#: threads of a block at most, and of an SM
MAX_BLOCK_THREADS = 1024
MAX_THREADS_PER_SM = 2048


class GatherPlan(NamedTuple):
    """A launch of the patch-gather kernel: its path, whole patches per
    block (the groups path's G), patch rows per warp (its R) and blocks.
    The C launcher derives the threads of a block from these and ``w``
    (:func:`block_threads`); the rows path launches a block per patch row
    whatever ``grid`` says."""
    path: int
    group: int
    rows_per_warp: int
    grid: int


def block_threads(plan: GatherPlan, w: int) -> int:
    """Threads of a block of ``plan`` for windows of ``w``, as the C
    launcher derives them: ``ROW_THREADS`` on the rows path, (32,
    ceil(G w / R)) on the groups path."""
    if plan.path == PATH_ROWS:
        return ROW_THREADS
    return 32 * -(-plan.group * w // plan.rows_per_warp)


#: patch rows a warp of the groups path takes: its loads of them all are
#: in flight at once
ROWS_PER_WARP = (1, 2, 4)


def groups_plan(batch: int, w: int, group: int, rows_per_warp: int,
                sms: int) -> GatherPlan:
    """The groups path at ``group`` patches a block and ``rows_per_warp``
    rows a warp: a grid of the groups, at most as many blocks as the card
    holds at once."""
    if rows_per_warp not in ROWS_PER_WARP:
        raise ValueError(f"rows_per_warp {rows_per_warp} not in "
                         f"{ROWS_PER_WARP}")
    plan = GatherPlan(PATH_GROUPS, group, rows_per_warp, 1)
    threads = block_threads(plan, w)
    if threads > MAX_BLOCK_THREADS:
        raise ValueError(f"{group} patches of {w} rows at {rows_per_warp} a "
                         f"warp need {threads} threads")
    return plan._replace(grid=min(-(-batch // group), sms * max(
        1, MAX_THREADS_PER_SM // threads)))


#: below this many patch rows a launch is latency alone: rows of at most
#: two rounds of a warp's lanes take the rows path there, whose chain from
#: launch to write is the shortest, and wider rows take one row a warp
SMALL_ROWS = 2048


def gather_plan(batch: int, w: int, channels: int, elt_bytes: int,
                sms: int) -> GatherPlan:
    """The launch of a (batch, w, w, channels) gather of ``elt_bytes``
    elements on a card of ``sms`` SMs.

    Wide rows whose pixels are a multiple of 8 bytes take the rows path
    (a block per patch row), and so do a window of more than 32 rows and
    a batch of fewer than ``SMALL_ROWS`` rows of at most 62 out chunks.
    The rest take the groups path: a warp takes 4 rows where a row's out
    chunks fit one round of its lanes (31 chunks of 16 bytes), else 2, and
    1 in a batch of fewer than ``SMALL_ROWS`` rows; a block takes 2 whole
    patches, 4 where a row needs more than two rounds, 1 in a small batch
    (and never more than 1024 threads hold).  Chosen from the device times
    of every plan at every launch site of ``chip_smoke.py`` on an H100
    (``PERF.md`` §6)."""
    if min(batch, w, channels, elt_bytes, sms) < 1:
        raise ValueError(f"no plan for batch {batch}, w {w}, channels "
                         f"{channels}, elements of {elt_bytes} bytes on "
                         f"{sms} SMs")
    row = w * channels * elt_bytes
    chunks = row // 16 + 2            # out chunks a row covers, at most
    small = batch * w < SMALL_ROWS
    if (w > 32 or (row >= ROWS_MIN_BYTES and channels * elt_bytes % 8 == 0)
            or (small and chunks <= 62)):
        return GatherPlan(PATH_ROWS, 1, 1, batch * w)
    per_warp = 1 if small else 4 if chunks <= 31 else 2
    group = 1 if small else min(4 if chunks > 62 else 2,
                                max(1, 32 * per_warp // w))
    return groups_plan(batch, w, group, per_warp, sms)


def card_sms(device: torch.device) -> int:
    """The SM count of ``device``'s card."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return _sms(index)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: the C entry point of each cube dtype
_ENTRY = {torch.float32: "cmlpl_patch_gather_f32",
          torch.bfloat16: "cmlpl_patch_gather_bf16"}


def launch_plan(cube: torch.Tensor, idx: torch.Tensor, cols: int, w: int,
                plan: GatherPlan | None = None) -> tuple[torch.Tensor, int]:
    """The kernel of ``cube``'s dtype on CUDA tensors, by ``plan``
    (:func:`gather_plan`'s by default): its output and the launches made
    (none for an empty batch).  The wrappers count those launches; a call
    here with another plan, to hold or time one path, counts none."""
    if not cube.is_contiguous() or not idx.is_contiguous():
        raise ValueError("cube and idx must be contiguous")
    b = idx.shape[0]
    if max(*cube.shape, b * w, w * w * cube.shape[-1]) >= 2 ** 31:
        raise ValueError(f"cube {tuple(cube.shape)} or {b} patches of {w} "
                         "rows exceed the kernel's 32-bit dims and grid")
    out = torch.empty((b, w, w, cube.shape[-1]), dtype=cube.dtype,
                      device=cube.device)
    if b == 0:
        return out, 0
    if plan is None:
        plan = gather_plan(b, w, cube.shape[-1], cube.element_size(),
                           card_sms(cube.device))
    fn_name = _ENTRY[cube.dtype]
    fn = getattr(_build.library(), fn_name)
    with torch.cuda.device(cube.device):
        stream = torch.cuda.current_stream(cube.device).cuda_stream
        err = fn(cube.data_ptr(), idx.data_ptr(), out.data_ptr(), b,
                 cube.shape[0], cube.shape[1], cube.shape[2], cols, w,
                 *plan, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError_t {err} "
                           f"({plan})")
    return out, 1


def gather_patches_f32(padded: torch.Tensor, idx: torch.Tensor, *,
                       cols: int, w: int) -> torch.Tensor:
    """Kernel 1: (B, w, w, C) f32 patches from the f32 padded cube
    (replaces ``gather_patches_pallas``, ``cmlpl_tpu/ops/patch_gather.py``
    ``:63-109``)."""
    _check(padded, idx, cols, w, torch.float32)
    if padded.device.type == "cpu":
        return gather_patches_plain(padded, idx, cols=cols, w=w)
    if padded.device.type != "cuda":
        raise ValueError(f"unsupported device {padded.device}")
    out, launched = launch_plan(padded, idx, cols, w)
    gather_patches_f32.launches += launched
    return out


def gather_patches_bf16(cube: torch.Tensor, idx: torch.Tensor, *,
                        cols: int, w: int) -> torch.Tensor:
    """Kernel 2: (B, w, w, C) bf16 patches from a plain bf16 cube
    (replaces ``gather_patches_pallas_shifted`` and its shift cube,
    ``cmlpl_tpu/ops/patch_gather.py:159-222``).  The map and the f32-input
    trainers upcast its patches to f32, as the JAX callers do; the
    bf16-input trainers keep them bf16."""
    _check(cube, idx, cols, w, torch.bfloat16)
    if cube.device.type == "cpu":
        return gather_patches_plain(cube, idx, cols=cols, w=w)
    if cube.device.type != "cuda":
        raise ValueError(f"unsupported device {cube.device}")
    out, launched = launch_plan(cube, idx, cols, w)
    gather_patches_bf16.launches += launched
    return out


gather_patches_f32.launches = 0
gather_patches_bf16.launches = 0

#: every kernel wrapper of the port, for resetting and reading the counts
WRAPPERS = (gather_patches_f32, gather_patches_bf16)


# --------------------------------------------------------------------------
# The kernels as operators that an exported graph carries
# --------------------------------------------------------------------------

#: the operators' namespace
OP_NAMESPACE = "cmlpl"
#: each wrapper's operator schema.  ``csrc/gather_ops.cpp`` registers the
#: same strings for the native runner, which has no Python (a CPU test
#: holds the two equal).
OP_SCHEMAS = {
    "gather_patches_f32":
    "gather_patches_f32(Tensor cube, Tensor idx, int cols, int w) -> Tensor",
    "gather_patches_bf16":
    "gather_patches_bf16(Tensor cube, Tensor idx, int cols, int w) -> Tensor",
}


def _register_ops() -> torch.library.Library:
    """``cmlpl::gather_patches_f32`` and ``cmlpl::gather_patches_bf16``:
    the wrappers as operators, so that ``make_fx`` and ``torch.export``
    record a kernel gather as one opaque node, and an AOTInductor package
    calls it by name.  Their CPU and CUDA kernels are the wrappers (the
    plain gather on CPU tensors; on CUDA tensors a counted launch, or an
    error); their fake kernel gives the plain gather's shape and dtype.
    Nothing is built here: the first launch builds."""
    lib = torch.library.Library(OP_NAMESPACE, "DEF")
    for wrapper in WRAPPERS:
        name = wrapper.__name__
        lib.define(OP_SCHEMAS[name])

        def kernel(cube, idx, cols, w, _wrapper=wrapper):
            return _wrapper(cube, idx, cols=cols, w=w)

        for key in ("CPU", "CUDA"):
            lib.impl(name, kernel, key)
        torch.library.register_fake(f"{OP_NAMESPACE}::{name}", _fake_gather,
                                    lib=lib)
    return lib


def _fake_gather(cube, idx, cols, w):
    return cube.new_empty((idx.shape[0], w, w, cube.shape[-1]))


# held for the process's life: a Library's registrations go with it
_OPS = _register_ops()


# --------------------------------------------------------------------------
# Training gathers (``cmlpl_tpu/ops/patch_gather.py:225-381``)
# --------------------------------------------------------------------------

#: Device-memory budget for the pre-gathered training pool under gather
#: "auto".  Kept at the JAX package's 2 GiB so that "auto" resolves exactly
#: as it does there; at the reference schedule the pool is 10,240 rows of
#: 20x20x60 f32, 0.98 GB, far under it and under the H100's 80 GB.
POOL_AUTO_BUDGET_BYTES = 2 << 30

#: Pool length quantum (rows).  ``poolify_batches`` pads every pool to a
#: multiple of this; ``resolve_gather_impl`` sizes its worst case with the
#: same constant so the two cannot drift.
POOL_BUCKET = 512

#: values of ``CMLPLConfig.gather_impl``
TRAIN_GATHERS = ("auto", "xla", "pallas", "pallas_bf16", "pool")


def resolve_gather_impl(gather_impl: str, *, num_unlabel: int,
                        patch_size: int, n_pc: int, num_labeled: int = 0,
                        pool_supported: bool = True) -> str:
    """Resolve the "auto" training-gather knob to a concrete impl, as the
    JAX package does.

    "auto" picks the pre-gathered pool (the same patch values as "xla")
    whenever the trainer supports one and the pool's worst-case f32
    footprint fits ``POOL_AUTO_BUDGET_BYTES``, else the per-step "xla"
    gather.  The worst case is at most ``num_unlabel`` unlabeled +
    ``num_labeled`` labeled unique pixels, rounded up to ``POOL_BUCKET``.
    The supervised trainer has no pool (``pool_supported=False``).
    Explicit impl names pass through."""
    if gather_impl != "auto":
        return gather_impl
    if not pool_supported:
        return "xla"
    uniques = max(num_unlabel + num_labeled, 1)
    pool_rows = -(-uniques // POOL_BUCKET) * POOL_BUCKET
    pool_bytes = pool_rows * patch_size * patch_size * n_pc * 4
    return "pool" if pool_bytes <= POOL_AUTO_BUDGET_BYTES else "xla"


def resolve_train_gather(gather_impl: str, device: torch.device, *,
                         num_unlabel: int, patch_size: int, n_pc: int,
                         num_labeled: int = 0,
                         pool_supported: bool = True) -> str:
    """The trainer's gather on ``device``: :func:`resolve_gather_impl`,
    except that on the card an "auto" that resolves to the plain gather (a
    pool over the budget, or a trainer with no pool) takes kernel 1 each
    step ("pallas", bitwise equal to "xla") instead, over any number of
    ranks: each rank gathers its whole batch itself.  The plain gather runs
    on the card only when "xla" is asked for by name."""
    impl = resolve_gather_impl(gather_impl, num_unlabel=num_unlabel,
                               patch_size=patch_size, n_pc=n_pc,
                               num_labeled=num_labeled,
                               pool_supported=pool_supported)
    if gather_impl == "auto" and impl == "xla" and device.type == "cuda":
        return "pallas"
    return impl


def check_gather_mesh(gather_impl: str, mesh) -> None:
    """Refuses a per-step kernel gather asked for by name ("pallas",
    "pallas_bf16") over a mesh of more than one rank, as the JAX package
    refuses it (``cmlpl_tpu/ops/patch_gather.py:270-279``, where
    ``pallas_call`` cannot be partitioned); the trainers check the
    ``gather_impl`` they were given, before "auto" is resolved.  The
    port's ranks gather their batches locally, so an over-budget "auto"
    still takes kernel 1 each step on each rank's card
    (:func:`resolve_train_gather`)."""
    if gather_impl not in ("xla", "pool", "auto") and mesh is not None \
            and mesh.size > 1:
        raise ValueError(
            f"gather_impl={gather_impl!r} requires a single-rank mesh (got "
            f"{mesh.size} ranks); use gather_impl='auto', 'xla' or 'pool' "
            "for multi-card training")


def poolify_batches(lab_idx, unl_idx, bucket: int = POOL_BUCKET):
    """Pool-mode host prep: the unique pixel ids of a run, an epoch or a
    step, and the batch id arrays re-expressed as positions into that pool.

    The pool is padded (repeating its first id) up to a multiple of
    ``bucket``, as in the JAX package, so the pools of the two packages
    hold the same rows."""
    li = np.asarray(lab_idx)
    ui = np.asarray(unl_idx)
    pool, inv = np.unique(np.concatenate([li.ravel(), ui.ravel()]),
                          return_inverse=True)
    li_pos = inv[:li.size].reshape(li.shape).astype(np.int32)
    ui_pos = inv[li.size:].reshape(ui.shape).astype(np.int32)
    padded_len = -(-len(pool) // bucket) * bucket
    pool = np.concatenate(
        [pool, np.full(padded_len - len(pool), pool[0], pool.dtype)])
    return pool.astype(np.int32), li_pos, ui_pos


def make_input_cast(compute_dtype: str, input_dtype: str):
    """The cast of the gathered patches and spectra, and so of the noise
    views drawn in their dtype (``CMLPLConfig.input_dtype``;
    ``cmlpl_tpu/ops/patch_gather.py:307-317``): to bf16 under bf16
    compute with ``input_dtype="compute"``, else to f32.  The layers cast
    their inputs to the compute dtype anyway; only the rounding point
    moves."""
    if input_dtype not in ("compute", "float32"):
        raise ValueError(f"unknown input_dtype {input_dtype!r}")
    dtype = (torch.bfloat16
             if (compute_dtype, input_dtype) == ("bfloat16", "compute")
             else torch.float32)
    return lambda a: a.to(dtype)


def make_train_gather(gather_impl: str, n_pc: int):
    """(prep_cube, gather) pair of the per-step training gather knob.

    ``prep_cube(padded)`` runs once per run, epoch or step (whatever one
    call of the trainer covers), outside the steps: identity for "xla"
    and "pallas", the bf16 copy of the cube for "pallas_bf16".
    ``gather(prepped, pixel_idx, cols, w)`` returns (B, w, w, n_pc)
    patches in the prepped cube's dtype: f32 from the plain gather
    ("xla") or kernel 1 ("pallas"), bf16 from kernel 2 ("pallas_bf16",
    patch inputs bf16-quantised).  The kernels are called as their
    operators (``cmlpl::gather_patches_*``), so the same gather runs in
    an eager step and, as one node, in a traced one
    (``train/functional.RunStep``).  The trainer casts them to its input
    dtype (:func:`make_input_cast`): under f32 inputs that is the JAX
    callers' upcast of kernel 2's patches, under bf16 inputs there is
    nothing to cast.  The kernel needs no 128-channel pad, unlike the TPU
    kernel."""
    if gather_impl == "xla":
        def gather(prepped, pixel_idx, cols, w):
            return gather_patches_plain(prepped, pixel_idx, cols=cols, w=w)

        return (lambda padded: padded), gather

    if gather_impl == "pallas":
        def gather(prepped, pixel_idx, cols, w):
            return torch.ops.cmlpl.gather_patches_f32(prepped, pixel_idx,
                                                      cols, w)

        return (lambda padded: padded), gather

    if gather_impl == "pallas_bf16":
        def gather(cube, pixel_idx, cols, w):
            out = torch.ops.cmlpl.gather_patches_bf16(cube, pixel_idx, cols,
                                                      w)
            return out[..., :n_pc]

        return (lambda padded: padded.to(torch.bfloat16)), gather

    # "pool" is gather_pool's, called by the trainer once per call
    raise ValueError(f"unknown per-step gather_impl {gather_impl!r}")


def gather_pool(padded: torch.Tensor, spectra: torch.Tensor,
                pool_idx: torch.Tensor, *, cols: int, w: int):
    """The training pool: (P, w, w, C) patches of the pool's pixel ids, by
    kernel 1 from an f32 cube or kernel 2 from a bf16 one, and their
    (P, bands) spectra.

    Replaces the JAX package's bulk gather of the pool and its cast
    (``cmlpl_tpu/train/cmlpl.py:206-227,468-474``), which is XLA's
    dynamic-slice gather there because the TPU kernel needed a 128-channel
    pad.  A gather copies, and a copy commutes with rounding, so kernel 2
    on ``padded.to(torch.bfloat16)`` is bitwise the cast of kernel 1's
    pool, without the f32 pool.  The steps then take rows of the pool by
    position."""
    kernel = (gather_patches_bf16 if padded.dtype == torch.bfloat16
              else gather_patches_f32)
    return (kernel(padded, pool_idx, cols=cols, w=w),
            spectra.index_select(0, pool_idx))
