#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cmlpl_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``cmlpl_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card and times both, then drives
the serving path at full width: BaseNet2 at PaviaU size (610x340x103
scene, n_PC 60, w 20, 9 classes, tiles of 512), random weights from a
seed (kernel 3, ``column_sums_seq``, is held at the prep's pixel matrix
(207,400 x 103), f32 and f64, bitwise its plain version and NumPy, at
the end, in a process of its own).  ``cli.serve`` answers four JSON
requests after its warm-up, each scene prepared on the card (kernel 3
three times a scene), its maps bitwise those of the card's prep and
tie-safe those of the host's; and ``cli.predict`` maps the scene with the bf16 gather; then dense
whole-scene eval (``predict --eval_gather dense``, card vs CPU).  Then
training: both kernels at the training shapes (the default run's pool,
B = 128 a step); three steps of each trainer (CMLPL, CPS, CCT) on the
card against the CPU; ``cli.train`` with the default 20-epoch schedule and
its pool gather (its net B weights then served), one epoch with each
per-step kernel gather; ``cli.train_cps`` and ``cli.train_cct`` with the
default schedule; and the OA of AB_SEEDS (6) of the reference's 12 seeds
of each CLI against its (``docs/{cmlpl,cps,cct}_ref_seeds_r4.json``).  Then bf16
training: ``cli.train --compute_dtype bfloat16`` with the default schedule
(its pool by the bf16 kernel), one epoch each of ``cli.train_cps`` and
``cli.train_cct`` in bf16, one bf16 step of each trainer on the card
against the CPU, and the 6-seed OA of bf16 ``cli.train``; a 4-epoch
``cli.train`` with a checkpoint an epoch, a fault injected after epoch 2
and one restart; one epoch with each extra objective and with the
augmentations, and a stacked against an unstacked CMLPL step.  Then the
rest of the single-card surface: ``cli.sample_generation`` of the
synthetic PaviaU scene against the port's prep; ``cli.train`` on its
splits for 2 epochs with ``--profile_dir`` (the trace names the gather
kernel) and ``--checkpoint_dir``; ``predict --checkpoint_dir`` of net B
(bitwise the map of ``--weights``) and net E, and a ``serve`` request
from the checkpoint; ``XP.npy`` of the 64x48 scene in chunks against the
plain gather; ``cli.train --num_iters 4 --fused_iters`` beside the serial
loop, the same pair with ``--extra_loss memobank``, and a bf16 fused epoch
(times, idle shares, each seed's OA), and 3 fused steps of 4 seeds
against 3 serial steps of each, for CMLPL, CMLPL with the memory bank,
CPS and CCT (functorch's per-example fallback an error).  Then the
comparison zoo: kernel 1 (and kernel 2 once) at every zoo (w, C) at
B = 512 and 45, both kernels at every zoo (w, C)'s edges (the cube's first
and last windows, B = 1, a ragged last group, a cube based one element
past an aligned allocation) and each kernel's B = 1 floor, with its
bound and the library call's time; three
supervised steps of each of the nine ``ZOO`` models
on the card against the CPU; ``cli.train_backbone`` for each, 100 epochs
at its defaults; and each model's mean OA against the JAX package's bank
(``docs/zoo_jax_seeds.json``).  Then export, in a process of its own,
its exports and compiles beside the zoo's phases after the zoo's kernels,
its maps and timings after the zoo:
``cli.export_model --verify --native_dir`` of the serving model's f32
``xla`` and ``dense`` maps and its bf16 ``xla`` map, each zip artifact's
map bitwise its ``ScenePredictor`` map (the f32 ``xla`` one also the
kernel-1 map that ``--verify`` launches), and the native runner
(``native/aoti_host.cpp``, built by ``g++`` in a thread from the start)
one-shot on each bundle and in ``--serve`` with a bad request.  Then the
training-run bundle: ``cli.export_model --train_bundle`` of the default
20-epoch f32 CMLPL run and of its 2-epoch memory-bank run
(``--extra_loss memobank``), exported and compiled in a process of its
own started with the smoke, and beside it a second one that holds one
noise-off epoch of the exported program (``.module()``) to the eager
trainer on the card, threefry2x32 on the card to the CPU, and a one-step
memory-bank program to the eager step on the same draws; the host's
least available memory is watched throughout; the bundle run by the runner
(``--inputs --outdir``) and in Python, the two held to each other, its
outputs imported (``--import_run``) and mapped by ``predict
--checkpoint_dir``, the map's OA held to the eager run's; the memory-bank
bundle run by the runner, imported and mapped.  Then the per-step bundle
(slice 11): both kernels' ``cmlpl`` operators bitwise the plain gather at
the kernels' sites and edges, by their Python registration in the kernel
phase and by their C++ one (``csrc/gather_ops.cpp``, the runner's, built
by ``g++`` in a thread) in a process of its own;
``cli.export_model --train_bundle --gather_impl pallas`` of the default
run, 2 epochs, exported and compiled in a third process from the start,
its package run there under the profiler (kernel 1 launched on the card 2
a step); each per-step mode's one-step program against the eager step of
its mode (the second process); the bundle run by the runner with the
operators' library, its ``ms_per_step`` beside the pool bundle's and the
eager per-step epoch's, imported and mapped.  The export phase holds the
runner's bf16 map, compiled with precision-cast emulation, to the
in-process bf16 map.  Then
multi-card data parallel (slice 12, ``core/mesh.py``): two gloo ranks on
the one card, processes of their own started beside the A/B phases and
driven through the library (``multihost_shared_card``): gloo's
collectives on CUDA tensors, one noise-off step of CMLPL, CPS and CCT
against the one-rank step, the two replicas bitwise equal after 3
noise-on steps, a bf16 step whose pool kernel 2 gathers, CMLPL steps
whose "auto" pool is over the budget (kernel 1 twice a step on each
rank), a 2-epoch CMLPL
run (one pool a rank) whose net B map, one strip of 203 tiles a rank
(kernel 1, counted by the wrapper and by the profiler), is bitwise the
one-rank map and whose dense map, one strip of scene rows a rank (no
gather), is tie-safe the one-rank dense map, and a step's gradient
all-reduce; then the zoo over the two ranks
(``multihost_shared_card_zoo``): one step of each zoo model with a
BatchNorm against the one-rank step (BatchNorm statistics of the global
batch), SSFTT's replicas after 3 steps with its dropout and the
augmentations, kernel 1 once a step under the profiler, and
``cli.train_backbone --multihost --model ssrn`` (100 launches in
training and 203 in its map's strip a rank, its map bitwise the one-rank
map of its weights); at the end ``cli.train --multihost`` as a one-rank
NCCL world, 2 epochs of the default cell beside the same run with no
process group (``multihost_world1``: OA within 1.0 point, one pool and
406 launches for each map, ``ms_per_step`` of both, one step's gradients
against the step with no group, the all-reduce and the draws every rank
repeats), and ``cli.train_backbone --multihost --model ssrn`` the same
way (``multihost_world1_zoo``: OA within 1.0 point, 100 and 406
launches, the BatchNorm all-reduces a step and their bytes).  Then
serving over ranks: on the two gloo ranks
(``multihost_shared_card_serve``), ``serve --multihost`` of random
weights on a PaviaU-size request and two bad ones (a missing cube, a
cube of 102 bands), in the default gather
(kernel 1, its warm-up through the broadcast too),
``--eval_gather pallas_bf16`` (kernel 2) and ``dense``: 203 launches a
rank a map by the wrappers and (kernels 1 and 2) the profiler, none
dense, rank 0's labels bitwise the one-rank map (dense
tie-safe), rank 1's stdout empty and its stdin unread, the scene
broadcast's bytes and ms; ``predict --multihost --checkpoint_dir`` of the
2-epoch run, bitwise the one-rank ``predict``; and in a one-rank NCCL
world beside no group (``multihost_world1_serve``): the labels bitwise,
406 launches each, ``latency_s`` of both.  Every
phase prints one JSON line, with ``at_s``, its process's seconds since it
started; the card's name and power limit, then a ``kernels`` line
(launches on the main path, error, times, bounds, launch plans and B = 1
floors) come before the last line, ``{"ok": true, "device": {...}}``.  Any failed check raises,
and the script exits non-zero without that line; so it does without CUDA.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import csv
import ctypes
import hashlib
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

T_IMPORT = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
DATA_ID, N_PC, W, TILE = 1, 60, 20, 512     # PaviaU width
HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
# every kernel of csrc/patch_gather.cu (patch_gather_rows_kernel,
# patch_gather_groups_kernel) holds this in its name, and no library
# kernel does
KERNEL_NEEDLE = "patch_gather_"
# kernel 3 (csrc/column_sums.cu): the latency of one of the dependent adds
# that bound it, assumed (the header's 4 cycles)
ADD_CYCLES = 4
FLOOR_SITE = (13, 5)                        # (w, C) of the B = 1 floor
FLOOR_LAUNCHES = 100
TIMING_ROUNDS = 3                           # passes over a map's tiles
TRAIN_EPOCHS = 20                           # the default schedule
#: a num_unlabel whose pool (30,208 rows of 96 kB, 2.9 GB) is over the
#: 2 GiB budget of gather "auto", which then takes kernel 1 each step
OVER_BUDGET_UNLABEL = 30_000
# card vs CPU, 3 training steps: cuDNN and oneDNN sum the convolutions in
# other orders, so the losses agree to about 1e-6 of their size, and the
# first step's gradients (same params, same inputs) to a small part of each
# tensor's largest.  Adam then divides each gradient by its own RMS, so a
# weight whose gradient RMS is within ILL_CONDITIONED times its tensor's
# largest card-vs-CPU gradient difference takes a step whose size is set
# by rounding, up to lr = 5e-4 a step, on either side: such weights are
# held only to that bound.  Their steps move every later gradient a little,
# so the others (their gradients agree to 1%) are held to half of the step
# the weight takes (one Adam's; two for CCT's encoder).  At most
# ILL_CONDITIONED_MAX_SHARE of all weights may need the loose bound, so a
# fault that widens the gradient gap fails
CARD_CPU_LOSS_RTOL, CARD_CPU_LOSS_ATOL = 1e-4, 1e-5
CARD_CPU_GRAD_TOL = 1e-3             # of each tensor's largest |gradient|
CARD_CPU_PARAM_RTOL, CARD_CPU_PARAM_ATOL = 1e-3, 2.5e-4
ILL_CONDITIONED = 100.0
ILL_CONDITIONED_MAX_SHARE = 1e-4
# mean OA points from the reference's: cuDNN's weight-gradient sums change
# order from run to run, so a correct port's seeds wander; a fault in the
# algorithm moves OA by far more
AB_MAX_DIFF = 3.0
# the A/B's seeds, the first of the reference's 12 (1088..1099): half of
# them, a depth cut for time (at 12, with the ("data", "model") mesh's
# phase, the whole smoke took 1,017-1,224 s, the A/B phases 376-489 s)
AB_SEEDS = 6
# bf16 card vs CPU, 1 step: cuDNN's and oneDNN's bf16 layers round their
# outputs to an 8-bit mantissa (2**-8 = 3.9e-3 of their size) at other
# points, so the losses, batch means of such outputs, agree to a few of
# those (the CPU tests hold the port to JAX at 2e-3).  The accuracy and
# mask rate count argmax and threshold decisions, which that rounding
# flips wherever two logits nearly tie, as they do at a random init: they
# are reported, not held.  The gradients sum up to 10^5 products of
# bf16-rounded operands: the two devices' step-1 gradients may differ by
# at most BF16_GRAD_FACTOR times what bf16 itself moves them by (bf16 vs
# the f32 step from the same state, on either device; each as the largest
# difference of a tensor over its largest entry).  Adam's first step moves
# each weight by lr times the sign of its gradient, so a weight differs by
# 0 or by 2 lr: all within 2 lr, and at most BF16_FLIPPED_MAX_SHARE of
# them by more than lr / 2 (the gradients of opposite sign; 0.2% in the
# CPU tests' 4 steps against JAX)
BF16_LOSS_RTOL, BF16_LOSS_ATOL = 5e-3, 5e-3
BF16_DECISIONS = ("acc", "mask_rate")
BF16_GRAD_FACTOR = 2.0
BF16_FLIPPED_MAX_SHARE = 2e-2
# stacked vs two forwards on the card, f32, noise and dropout off: the
# two nets' convolutions run as one grouped convolution, which the library
# may compute by another algorithm, so sums in another order; the card-vs-
# CPU bounds.  (With the noise views on, the first step's weight gradients
# cancel so far that two convolution libraries' algorithms disagree by
# 1-2% of a tensor's largest on the CPU for the same two-forward step)
STACK_LOSS_RTOL, STACK_GRAD_TOL = CARD_CPU_LOSS_RTOL, CARD_CPU_GRAD_TOL
RESUME_EPOCHS, FAIL_AT_EPOCH = 4, 2
# the comparison zoo (cli.train_backbone): the labeled split's batch (5
# labels a class), the CLI docstring's epochs, and the flags that one
# model each adds to its run
ZOO_BATCH, ZOO_EPOCHS, ZOO_STEPS_CHECKED = 45, 100, 3
ZOO_EXTRA = {"ssrn": ["--ema_teacher", "0.95"],
             "dbda": ["--augment", "flip", "rot90", "radiation"],
             "basenet1": ["--epoch_samples", "1280"]}
# BN running statistics after ZOO_STEPS_CHECKED card-vs-CPU steps: a conv
# bias read only by train-mode BNs has an exact gradient of 0, so Adam
# steps it by rounding on either device (up to lr a step), and it shifts
# those BNs' running means by (1 - momentum) of that, momentum 0.9 at most
# a gradient tensor whose largest entry is not 0 but below this share of
# the model's largest is rounding: its exact value is 0.  On the CPU at a
# random init such tensors of the zoo lie under 4e-6 of it, all others
# above 2e-3
ROUNDING_ONLY = 1e-4
ZOO_STATS_ATOL = CARD_CPU_PARAM_ATOL + 0.1 * ZOO_STEPS_CHECKED * 2 * 5e-4
# zoo_ab: the models trained against docs/zoo_jax_seeds.json, each at
# the bank's seeds
ZOO_AB_MODELS = ("basenet1", "basenet2", "basenet2_zoo", "ssftt", "dbda",
                 "dbda_feature", "ssrn", "fdssc", "msvit")


class CheckFailed(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(obj) -> None:
    """One JSON line, with this process's seconds since it started."""
    print(json.dumps({**obj, "at_s": time.perf_counter() - T_IMPORT}),
          flush=True)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, args_list, rounds: int = TIMING_ROUNDS) -> float:
    """Mean device ms per call of ``fn(*args)`` over ``args_list``, after a
    warm-up pass, from CUDA events around ``rounds`` passes."""
    for args in args_list:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        for args in args_list:
            fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (rounds * len(args_list))


def profiled(fn, args_list):
    """One pass of ``fn(*args)`` over ``args_list`` under the profiler,
    after ``CUPTI_SETTLE_S`` of wait (CUPTI may drop the records of the
    kernels launched first): returns (device ms per kernel name, launches
    per kernel name, wall ms of the pass)."""
    from torch.profiler import ProfilerActivity, profile

    from cmlpl_tpu_torch.utils.profiling import CUPTI_SETTLE_S

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(CUPTI_SETTLE_S)
        t0 = time.perf_counter()
        for args in args_list:
            fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms, counts = {}, {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us > 0:
            dev_ms[e.key] = us / 1e3
            counts[e.key] = e.count
    return dev_ms, counts, wall_ms


def kernel_device_ms(fn, args_list, needle: str = KERNEL_NEEDLE) -> float:
    """Device ms per launch of the kernels whose name holds ``needle``, from
    the profiler; fails when the profiler saw no such kernel."""
    dev_ms, counts, _ = profiled(fn, args_list)
    keys = [k for k in dev_ms if needle in k]
    n = sum(counts[k] for k in keys)
    require(n > 0, f"the profiler saw no kernel named {needle!r}: "
            f"{sorted(dev_ms)[:8]}")
    return sum(dev_ms[k] for k in keys) / n


def call_device_ms(fn, args_list):
    """Device ms per call of ``fn(*args)``, every kernel it launches
    counted, from the profiler, or None when it saw no device time.  Each
    kernel's time is taken per launch and times its launches per call, so
    a launch the profiler misses does not shorten the call."""
    dev_ms, counts, _ = profiled(fn, args_list)
    n = len(args_list)
    return sum(ms / counts[k] * max(1, round(counts[k] / n))
               for k, ms in dev_ms.items()) or None


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def tf32_flags() -> tuple:
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def phase_tf32_scope(device, flags_at_start) -> None:
    """Inside a BaseNet2's convolutions on the card the TF32 switches follow
    its compute dtype; building and running a bf16 then an f32 model leaves
    the process's switches as the smoke found them."""
    import torch.nn.functional as F

    from cmlpl_tpu_torch.models.basenet import BaseNet2

    seen = []
    conv2d = F.conv2d

    def spy(*args, **kwargs):
        seen.append(tf32_flags())
        return conv2d(*args, **kwargs)

    xp = torch.zeros(2, W, W, N_PC, device=device)
    x = torch.zeros(2, 103, device=device)
    inside = {}
    F.conv2d = spy
    try:
        for dtype in ("bfloat16", "float32"):
            seen.clear()
            model = BaseNet2(n_pc=N_PC, patch_size=W,
                             compute_dtype=dtype).to(device)
            with torch.no_grad():
                model(xp, x)
            inside[dtype] = sorted(set(seen))
            require(tf32_flags() == flags_at_start,
                    f"{dtype} model left TF32 at {tf32_flags()}")
    finally:
        F.conv2d = conv2d
    require(inside == {"bfloat16": [(True, True)],
                       "float32": [(False, False)]},
            f"TF32 inside the models' convolutions: {inside}")
    emit({"phase": "tf32_scope", "flags_at_start": list(flags_at_start),
          "inside_convolutions": {k: [list(f) for f in v]
                                  for k, v in inside.items()}})


def map_tiles(num_pixels: int, device) -> list[torch.Tensor]:
    """The main path's tiles: ids 0..K-1 in tiles of TILE, the last one
    padded with pixel 0 (ScenePredictor's decomposition)."""
    padded_k = -(-num_pixels // TILE) * TILE
    idx = np.arange(padded_k, dtype=np.int32)
    idx[num_pixels:] = 0
    return list(torch.from_numpy(idx).to(device).split(TILE))


class _CUmemLocation(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]


class _CUmemAllocationProp(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("requestedHandleTypes", ctypes.c_int),
                ("location", _CUmemLocation),
                ("win32HandleMetaData", ctypes.c_void_p),
                ("compressionType", ctypes.c_ubyte),
                ("gpuDirectRDMACapable", ctypes.c_ubyte),
                ("usage", ctypes.c_ushort),
                ("reserved", ctypes.c_ubyte * 4)]


class _CUmemAccessDesc(ctypes.Structure):
    _fields_ = [("location", _CUmemLocation), ("flags", ctypes.c_int)]


class _DeviceArray:
    """``__cuda_array_interface__`` of device memory that torch wraps
    without owning it."""

    def __init__(self, ptr: int, shape, typestr: str):
        self.__cuda_array_interface__ = {
            "shape": tuple(shape), "typestr": typestr, "data": (ptr, False),
            "strides": None, "version": 2}


@contextlib.contextmanager
def fenced(cube: torch.Tensor, at_end: bool):
    """A copy of ``cube`` on the card in memory that is mapped alone, its
    neighbours on both sides reserved and unmapped (CUDA's virtual memory
    API), so that a read outside the mapping fails the launch with an
    illegal address.  The copy starts at the mapping's first byte, or ends
    at its last (``at_end``; its base then only element-aligned)."""
    cu = ctypes.CDLL("libcuda.so.1")
    u64, size_t = ctypes.c_uint64, ctypes.c_size_t
    sigs = {"cuMemGetAllocationGranularity": (ctypes.POINTER(size_t),
                                              ctypes.c_void_p, ctypes.c_int),
            "cuMemAddressReserve": (ctypes.POINTER(u64), size_t, size_t,
                                    u64, u64),
            "cuMemCreate": (ctypes.POINTER(u64), size_t, ctypes.c_void_p,
                            u64),
            "cuMemMap": (u64, size_t, size_t, u64, u64),
            "cuMemSetAccess": (u64, size_t, ctypes.c_void_p, size_t),
            "cuMemUnmap": (u64, size_t), "cuMemRelease": (u64,),
            "cuMemAddressFree": (u64, size_t)}
    fns = {}
    for name, argtypes in sigs.items():
        fns[name] = getattr(cu, name)
        fns[name].argtypes, fns[name].restype = argtypes, ctypes.c_int

    def call(name, *args):
        err = fns[name](*args)
        require(err == 0, f"{name}: CUresult {err}")

    dev = cube.device.index if cube.device.index is not None else \
        torch.cuda.current_device()
    where = _CUmemLocation(1, dev)           # CU_MEM_LOCATION_TYPE_DEVICE
    prop = _CUmemAllocationProp(type=1, location=where)   # ..._PINNED
    gran = size_t()
    call("cuMemGetAllocationGranularity", ctypes.byref(gran),
         ctypes.byref(prop), 0)
    g = gran.value
    nbytes = cube.numel() * cube.element_size()
    size = -(-nbytes // g) * g
    va, handle = u64(), u64()
    call("cuMemAddressReserve", ctypes.byref(va), size + 2 * g, 0, 0, 0)
    base = va.value + g
    mapped = created = False
    try:
        call("cuMemCreate", ctypes.byref(handle), size, ctypes.byref(prop),
             0)
        created = True
        call("cuMemMap", base, size, 0, handle.value, 0)
        mapped = True
        call("cuMemSetAccess", base, size,
             ctypes.byref(_CUmemAccessDesc(where, 3)), 1)   # read, write
        lo = base + size - nbytes if at_end else base
        view = torch.as_tensor(_DeviceArray(
            lo, cube.shape, "<f4" if cube.element_size() == 4 else "<i2"),
            device=cube.device).view(cube.dtype)
        view.copy_(cube)
        yield view
    finally:
        torch.cuda.synchronize()
        if mapped:
            call("cuMemUnmap", base, size)
        if created:
            call("cuMemRelease", handle.value)
        call("cuMemAddressFree", va.value, size + 2 * g)


def edge_cases(cube, cols: int, w: int, group: int | None = None):
    """(ids cases, bases) at the kernel's edges for windows of ``w``.  The
    cases, each (label, ids, cols): the cube's first and last windows, B =
    1, and B = G + 1 (a ragged last group, G ``group`` or the plan's at a
    map tile).
    The first window begins at the cube's first byte and is taken at out
    rows that are and are not 16-byte aligned; the last ends at the cube's
    last byte: start (rows - w, cols' - 1) under the divisor cols' =
    cube_cols - w + 1.  The bases, each (label, a context that yields the
    cube): ``cube`` itself, a copy whose base lies one element past an
    aligned allocation, and copies that start or end at an unmapped
    neighbour (``fenced``), where a read outside the cube fails."""
    rows_c, cols_c, ch = cube.shape
    last_cols = cols_c - w + 1
    dev = cube.device
    last = (rows_c - w) * last_cols + last_cols - 1
    first_last = torch.tensor([0, last, 0, 0], dtype=torch.int32, device=dev)
    if group is None:
        group = map_tile_group(w, ch, cube.element_size())
    g = torch.Generator(device=dev).manual_seed(SEED + 1000 * w + ch)
    one = torch.randint(0, rows_c * cols, (1,), generator=g, device=dev,
                        dtype=torch.int32)
    ragged = torch.cat([first_last[1:2], torch.randint(
        0, rows_c * last_cols, (group,), generator=g, device=dev,
        dtype=torch.int32)])

    @contextlib.contextmanager
    def offset():
        flat = torch.empty(cube.numel() + 1, dtype=cube.dtype, device=dev)
        flat[1:] = cube.reshape(-1)
        yield flat[1:].view(cube.shape)

    cases = [("first and last windows", first_last, last_cols),
             ("B=1", one, cols), (f"B=G+1={group + 1}", ragged, last_cols)]
    bases = [("aligned base", lambda: contextlib.nullcontext(cube)),
             ("base + 1 element", offset),
             ("fenced below", lambda: fenced(cube, at_end=False)),
             ("fenced above", lambda: fenced(cube, at_end=True))]
    return cases, bases


def map_tile_group(w: int, channels: int, elt_bytes: int) -> int:
    """G of the launch plan of a map tile (B = ``TILE``) on this card."""
    from cmlpl_tpu_torch.ops.patch_gather import card_sms, gather_plan

    return gather_plan(TILE, w, channels, elt_bytes,
                       card_sms(torch.device("cuda"))).group


def check_edges(name: str, wrapper, cube, cols: int, w: int,
                phase: str) -> float:
    """``wrapper`` bitwise equal to the plain gather at every edge case and
    base, and so is the groups path at 1 and 2 patches a block and every
    rows a warp that fits (a small batch takes the rows path by plan);
    returns the largest absolute difference (0)."""
    from cmlpl_tpu_torch.data.patches import gather_patches
    from cmlpl_tpu_torch.ops.patch_gather import (MAX_BLOCK_THREADS,
                                                  ROWS_PER_WARP, card_sms,
                                                  groups_plan, launch_plan)

    max_err = 0.0
    cases, bases = edge_cases(cube, cols, w)
    for base, make in bases:
        with make() as cb:
            for case, ids, c in cases:
                want = gather_patches(cb, ids, cols=c, w=w)
                runs = {"plan": wrapper(cb, ids, cols=c, w=w)}
                for group in (1, 2):
                    for per_warp in ROWS_PER_WARP:
                        if 32 * -(-group * w // per_warp) > MAX_BLOCK_THREADS:
                            continue
                        plan = groups_plan(ids.shape[0], w, group, per_warp,
                                           card_sms(cb.device))
                        runs[f"groups G={group} R={per_warp}"] = launch_plan(
                            cb, ids, c, w, plan)[0]
                torch.cuda.synchronize()
                label = f"{case}, {base} w={w} C={cube.shape[-1]}"
                for how, got in runs.items():
                    require(got.shape == want.shape
                            and got.dtype == cube.dtype,
                            f"{name} {label} {how}: shape/dtype")
                    require(torch.equal(bits(got), bits(want)),
                            f"{name} {label} {how}: not bitwise equal to the "
                            "plain gather")
                    max_err = max(max_err, float((got.float() - want.float())
                                                 .abs().max()))
                emit({"phase": phase, "kernel": name, "case": label,
                      "launches": sorted(runs), "bitwise_equal": True})
    return max_err


def kernel_cases(scene, device):
    """The sites the kernels are held at, each (label, f32 cube, ids, cols,
    w): the serving shape (a map tile and the last tile), odd w 9, w 8, a
    ragged batch of 21 with ids off the scene, and the training step's B =
    128; and the map's tiles."""
    rows, cols = scene.rows, scene.cols
    g = torch.Generator(device=device).manual_seed(SEED)
    cases = []
    tiles = map_tiles(rows * cols, device)
    cases.append(("serving B=512 w=20", scene.padded_pca, tiles[123], cols,
                  W))
    cases.append(("last tile B=512 w=20", scene.padded_pca, tiles[-1], cols,
                  W))
    for w, b in ((9, 512), (8, 512)):
        hw = w // 2 if w % 2 == 0 else (w - 1) // 2
        cube = torch.randn(rows + 2 * hw, cols + 2 * hw, N_PC, generator=g,
                           device=device)
        idx = torch.randint(0, rows * cols, (b,), generator=g, device=device,
                            dtype=torch.int32)
        cases.append((f"random B={b} w={w}", cube, idx, cols, w))
    edge = torch.tensor([0, cols - 1, rows * cols - 1, rows * cols, -1,
                         -cols - 3, 10 ** 6, -(10 ** 6)], dtype=torch.int32,
                        device=device)
    ragged = torch.cat([edge, torch.randint(0, rows * cols, (13,),
                                            generator=g, device=device,
                                            dtype=torch.int32)])
    cases.append(("ragged B=21 w=9 with edge ids", cases[2][1], ragged, cols,
                  9))
    cases.append(("training step B=128 w=20", scene.padded_pca,
                  torch.randint(0, rows * cols, (128,), generator=g,
                                device=device, dtype=torch.int32), cols, W))
    return cases, tiles


#: the operators of kernels 1 and 2 (``cmlpl::gather_patches_*``), by the
#: kernel they launch
OPERATORS = {"patch_gather_f32": ("gather_patches_f32", torch.float32),
             "patch_gather_bf16": ("gather_patches_bf16", torch.bfloat16)}


def check_operators(scene, device, registration: str, groups=None) -> dict:
    """Each ``cmlpl::gather_patches_*`` operator on CUDA tensors bitwise
    the plain gather at every site of :func:`kernel_cases` and at the
    serving shape's edges, the fenced cubes' too (``edge_cases``; ``groups``
    the plan's G of each kernel, where the caller cannot plan).  Returns
    {kernel: the largest absolute difference (0)}."""
    from cmlpl_tpu_torch.data.patches import gather_patches

    cases, _ = kernel_cases(scene, device)
    report = {}
    for name, (op_name, dtype) in OPERATORS.items():
        op = getattr(torch.ops.cmlpl, op_name)
        max_err, held = 0.0, 0

        def check(label, cube, ids, c, w):
            got = op(cube, ids, c, w)
            want = gather_patches(cube, ids, cols=c, w=w)
            torch.cuda.synchronize()
            require(got.shape == want.shape and got.dtype == dtype,
                    f"{registration} {op_name} {label}: shape/dtype")
            require(torch.equal(bits(got), bits(want)),
                    f"{registration} {op_name} {label}: not bitwise equal "
                    "to the plain gather")
            return float((got.float() - want.float()).abs().max())

        for label, cube, idx, c, w in cases:
            max_err = max(max_err, check(label, cube.to(dtype).contiguous(),
                                         idx, c, w))
            held += 1
        cube = scene.padded_pca.to(dtype).contiguous()
        edges, bases = edge_cases(cube, scene.cols, W,
                                  None if groups is None else groups[name])
        for base, make in bases:
            with make() as cb:
                for case, ids, c in edges:
                    max_err = max(max_err, check(f"{case}, {base}", cb, ids,
                                                 c, W))
                    held += 1
        report[name] = max_err
        emit({"phase": "operator_vs_plain", "operator": f"cmlpl::{op_name}",
              "registration": registration, "kernel": name,
              "cases": held, "bitwise_equal": True})
    return report


def run_cxx_operator_checks(library: str, group_f32: str,
                            group_bf16: str) -> dict:
    """:func:`check_operators` on the C++ registration of the operators
    (``csrc/gather_ops.cpp``, the native runner's), in a process that
    loads that library and nothing of the port's ``ops`` (whose Python
    registration of the same namespace would refuse it)."""
    from cmlpl_tpu_torch.data.io import synthetic_scene
    from cmlpl_tpu_torch.data.prep import prepare_scene

    torch.ops.load_library(library)
    require("cmlpl_tpu_torch.ops.patch_gather" not in sys.modules,
            "the C++ operators' check imported the Python registration")
    device = torch.device("cuda")
    cube, gt = synthetic_scene(DATA_ID)
    scene = prepare_scene(DATA_ID, cube=cube, gt=np.zeros_like(gt),
                          patch_size=W, n_pc=N_PC, device=device)
    report = check_operators(
        scene, device, "C++ (csrc/gather_ops.cpp)",
        {"patch_gather_f32": int(group_f32),
         "patch_gather_bf16": int(group_bf16)})
    return {"max_abs_err": report}


def phase_kernels(scene, device):
    """Both kernels vs the plain gather, bitwise, at the sites of
    :func:`kernel_cases` and at the serving shape's edges
    (``edge_cases``); then their times over one map's tiles beside the
    plain version's, one PyTorch library call's and the bound; then both
    kernels' operators (their Python registration) at the same sites and
    edges."""
    from cmlpl_tpu_torch.data.patches import gather_patches
    from cmlpl_tpu_torch.ops.patch_gather import (gather_patches_bf16,
                                                  gather_patches_f32)

    cols = scene.cols
    cases, tiles = kernel_cases(scene, device)
    kernels = {"patch_gather_f32": (gather_patches_f32, torch.float32),
               "patch_gather_bf16": (gather_patches_bf16, torch.bfloat16)}
    report = {}
    for name, (wrapper, dtype) in kernels.items():
        max_err = 0.0
        for label, cube, idx, c, w in cases:
            cube = cube.to(dtype).contiguous()
            got = wrapper(cube, idx, cols=c, w=w)
            want = gather_patches(cube, idx, cols=c, w=w)
            torch.cuda.synchronize()
            require(got.shape == want.shape and got.dtype == dtype,
                    f"{name} {label}: shape/dtype")
            require(torch.equal(bits(got), bits(want)),
                    f"{name} {label}: not bitwise equal to the plain gather")
            max_err = max(max_err,
                          float((got.float() - want.float()).abs().max()))
            emit({"phase": "kernel_vs_plain", "kernel": name, "case": label,
                  "bitwise_equal": True})

        cube = scene.padded_pca.to(dtype).contiguous()
        max_err = max(max_err, check_edges(name, wrapper, cube, cols, W,
                                           "kernel_vs_plain"))
        times = gather_times(wrapper, cube, tiles, cols)
        report[name] = {"max_abs_err": max_err, "ms": times["ms"],
                        "kernel_ms": times["ms"], **times,
                        "tiles_timed": len(tiles)}
        emit({"phase": "kernel_timing", "kernel": name, **report[name]})
    for name, err in check_operators(scene, device,
                                     "Python (ops/patch_gather.py)").items():
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
    return report


def gather_times(wrapper, cube, id_list, cols: int,
                 rounds: int = TIMING_ROUNDS, w: int = W) -> dict:
    """Per-launch times of a gather kernel over the id tensors of
    ``id_list`` (one launch each, windows of ``w``) beside the plain
    gather's, one PyTorch library call's and the byte bound."""
    from cmlpl_tpu_torch.data.patches import clamped_starts, gather_patches
    from cmlpl_tpu_torch.ops.patch_gather import card_sms, gather_plan

    elt = cube.element_size()
    rc = [clamped_starts(t, cols, cube.shape[0], cube.shape[1], w)
          for t in id_list]
    # library yardstick: every window as a view, one advanced index per
    # call; (B, C, w, w) viewed as (B, w, w, C)
    windows = cube.unfold(0, w, 1).unfold(1, w, 1)

    def library(r, c):
        return windows[r, c].permute(0, 2, 3, 1)

    require(torch.equal(library(*rc[0]), gather_patches(
        cube, id_list[0], cols=cols, w=w)), "library call differs")
    args = [(t,) for t in id_list]
    ms = cuda_ms(lambda t: wrapper(cube, t, cols=cols, w=w), args, rounds)
    plain_ms = cuda_ms(lambda t: gather_patches(cube, t, cols=cols, w=w),
                       args, rounds)
    library_ms = cuda_ms(library, rc, rounds)
    # the profiler misses a window's first launch: give it several
    device_ms = kernel_device_ms(lambda t: wrapper(cube, t, cols=cols, w=w),
                                 args * rounds)
    library_device_ms = call_device_ms(library, rc * rounds)
    # bytes the function must move per launch: each output written once,
    # the ids and each cube pixel that its windows touch read once
    touched = 0
    off = torch.arange(w, device=cube.device)
    for r, c in rc:
        mask = torch.zeros(cube.shape[:2], dtype=torch.bool,
                           device=cube.device)
        mask[(r[:, None] + off)[:, :, None],
             (c[:, None] + off)[:, None, :]] = True
        touched += int(mask.sum())
    batch = id_list[0].shape[0]
    out_bytes = batch * w * w * cube.shape[-1] * elt
    in_bytes = touched / len(id_list) * cube.shape[-1] * elt + batch * 4
    plan = gather_plan(batch, w, cube.shape[-1], elt, card_sms(cube.device))
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "bound_ms": (out_bytes + in_bytes) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes_per_launch": out_bytes + in_bytes,
            "plan": plan._asdict()}


def sm_max_hz() -> float:
    """The card's highest SM clock, in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0].split()[0]) * 1e6


def phase_column_sums(cube: np.ndarray, device) -> dict:
    """Kernel 3 (``column_sums_seq``) at the device prep's shape, the
    scene's pixel matrix (207,400 x 103 at PaviaU), in f32 and f64: its
    sums, and its squared deviations from the columns' NumPy means, each
    bitwise its plain version (``column_sums_plain``) on the card and
    NumPy's ``sum(0)``; its times beside the plain version's, one
    ``torch.sum(x, 0)``'s (the same sums in another order) and its bound,
    the larger of the chain of dependent adds at ADD_CYCLES each at the
    card's highest SM clock and the bytes read, from CUDA events.
    Returns {"f32" / "f64": report}."""
    from cmlpl_tpu_torch.ops.column_sums import (column_sums_plain,
                                                 column_sums_seq)

    flat = cube.reshape(-1, cube.shape[-1])
    n = flat.shape[0]
    hz = sm_max_hz()
    report = {}
    for name, dtype in (("f32", np.float32), ("f64", np.float64)):
        xn = np.ascontiguousarray(flat, dtype=dtype)
        centre = xn.mean(0)
        dev = xn - centre
        x = torch.from_numpy(xn).to(device)
        c = torch.from_numpy(centre).to(device)
        chain_ms = n * ADD_CYCLES / hz * 1e3
        bytes_ms = xn.nbytes / HBM_BYTES_PER_S * 1e3
        rep = {"rows": n, "cols": xn.shape[1], "bound_ms":
               max(chain_ms, bytes_ms), "bound_by": "dependent adds"
               if chain_ms > bytes_ms else "bytes", "chain_ms": chain_ms,
               "bytes_ms": bytes_ms, "sm_max_hz": hz}
        for label, args, want in (("sums", (x,), xn.sum(0)),
                                  ("squares", (x, c), (dev * dev).sum(0))):
            launches = column_sums_seq.launches
            got = column_sums_seq(*args)
            torch.cuda.synchronize()
            require(column_sums_seq.launches == launches + 1,
                    f"column_sums_seq {name} {label}: launches "
                    f"{column_sums_seq.launches - launches}, want 1")
            t0 = time.perf_counter()
            plain = column_sums_plain(*args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            require(got.dtype == plain.dtype and got.shape == plain.shape,
                    f"column_sums_seq {name} {label}: shape/dtype")
            require(torch.equal(bits(got), bits(plain)),
                    f"column_sums_seq {name} {label}: not bitwise its plain "
                    "version")
            require(np.array_equal(got.cpu().numpy(), want),
                    f"column_sums_seq {name} {label}: not bitwise NumPy's "
                    "sum(0)")

            def kernel():
                return column_sums_seq(*args)

            def library():
                return torch.sum(args[0], 0)

            launched = [()] * 20
            ms = cuda_ms(kernel, launched, rounds=1)
            rep[label] = {"ms": ms, "cycles_per_add": ms * 1e-3 * hz / n,
                          "plain_ms": plain_ms,
                          "library_ms": cuda_ms(library, launched, rounds=1)}
            emit({"phase": "kernel_vs_plain", "kernel": "column_sums_seq",
                  "case": f"{name} {label} ({n}, {xn.shape[1]})",
                  "bitwise_equal": True, "bitwise_numpy": True})
        # the kernel's headline: the plain sums, as the prep's first pass
        report[name] = {"max_abs_err": 0.0, "ms": rep["sums"]["ms"],
                        "plain_ms": rep["sums"]["plain_ms"],
                        "library_ms": rep["sums"]["library_ms"], **rep}
        emit({"phase": "kernel_timing", "kernel": f"column_sums_seq {name}",
              **report[name]})
    return report


def run_column_sums_child() -> dict:
    """:func:`phase_column_sums` on the synthetic PaviaU scene, in a
    process of its own, after the smoke's other phases: run in the smoke's
    process before its training phases (with or without its profiler
    sessions), or in a process of its own at that point, it was followed
    there by a profiler session of kernel 1's training pool (five
    launches) that recorded no kernel at all on an H100."""
    from cmlpl_tpu_torch.data.io import synthetic_scene

    cube, _ = synthetic_scene(DATA_ID)
    return phase_column_sums(cube, torch.device("cuda"))


class ResponseLog(io.StringIO):
    """serve's stdout: records the f32 gather's launch count at each
    response line, so each request's launches can be read."""

    def __init__(self, counter_fn):
        super().__init__()
        self.counter_fn = counter_fn
        self.counts = []

    def write(self, s):
        self.counts.extend([self.counter_fn()] * s.count("\n"))
        return super().write(s)


def tiled_logits(logits_fn_, scene):
    """``ids -> logits`` of the tiled map's model at those pixels."""
    from cmlpl_tpu_torch.data.patches import gather_patches, gather_spectra

    def at(ids):
        idx = torch.from_numpy(ids.astype(np.int32)).to(scene.device)
        with torch.inference_mode():
            return logits_fn_(
                gather_patches(scene.padded_pca, idx, cols=scene.cols, w=W),
                gather_spectra(scene.spectra, idx))
    return at


def tie_safe_equal(got, want, logits_at, what: str) -> None:
    """Maps from two devices may differ only where the two best logits
    (``logits_at(pixel ids)``) lie within 1e-5 (f32 sums in another order
    can swap them)."""
    diff = np.nonzero(got != want)[0]
    if diff.size:
        top2 = logits_at(diff).topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        require((gaps < 1e-5).all(),
                f"{what}: {diff.size} pixels differ, gaps {gaps[:8]}")


def hold_served(served, card_map, host_map, host_logits_at,
                what: str) -> int:
    """A map that ``serve`` answered, its scene prepared on the card, is
    bitwise the map of the same weights on the card's prep of that scene
    (``card_map``), and tie-safe the map on the host's prep (``host_map``,
    ``host_logits_at`` its logits), whose PCA features are within one f32
    step.  Returns the pixels where it differs from ``host_map``."""
    require(np.array_equal(served, card_map),
            f"{what}: not bitwise the map of the card's prep")
    tie_safe_equal(served, host_map, host_logits_at,
                   f"{what} vs the map of the host's prep")
    return int((served != host_map).sum())


def run_cli(main_fn, argv, counter_fn):
    """``main_fn(argv)`` with its stdout captured; returns (its result, its
    output lines, the kernel counts as each line was written)."""
    log = ResponseLog(counter_fn)
    with contextlib.redirect_stdout(log):
        result = main_fn(argv)
    return result, log.getvalue().splitlines(), log.counts


def line_value(lines, counts, prefix: str):
    """(float after '== ' on the line that starts with ``prefix``, the
    kernel counts when it was written)."""
    for i, ln in enumerate(lines):
        if ln.startswith(prefix):
            return float(re.search(r"== ([0-9.]+)s", ln).group(1)), counts[i]
    raise CheckFailed(f"no line {prefix!r} in {lines[-8:]}")


def read_history(path: str) -> dict:
    """--metrics_csv as column -> float array."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {k: np.array([float(r[k]) for r in rows]) for k in rows[0]}


def default_schedule(labels, epochs: int):
    """(E, 78, 128) labeled ids, labels and unlabeled ids of the default
    schedule (5 labels a class, batches 128/128, ``num_unlabel`` 10,000,
    seed 1088), drawn by the port's sampler."""
    from cmlpl_tpu_torch.data.pipeline import SemiSupervisedSampler
    from cmlpl_tpu_torch.data.splits import generate_splits
    from cmlpl_tpu_torch.train.driver import stack_schedule

    return stack_schedule(SemiSupervisedSampler(
        generate_splits(labels, num_label=5), labels, 128, 128, 10000,
        seed=1088), epochs)


def phase_train_gather(scene, labels, device):
    """Both kernels vs the plain gather, bitwise, at the training shapes:
    the default schedule's pool on the synthetic PaviaU scene (the port's
    sampler, then poolify_batches; f32, and bf16 as the bf16 trainers
    gather it) and B = 128 random ids; then the times of each shape beside
    the plain gather's, the library call's and the bound."""
    from cmlpl_tpu_torch.data.patches import gather_patches
    from cmlpl_tpu_torch.ops.patch_gather import (gather_patches_bf16,
                                                  gather_patches_f32,
                                                  poolify_batches)

    li, _, ui = default_schedule(labels, TRAIN_EPOCHS)
    pool, _, _ = poolify_batches(li, ui)
    require(pool.shape == (10240,), f"pool of {pool.shape}")
    pool = torch.from_numpy(pool).to(device)
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    cols = scene.cols
    step_ids = [torch.randint(0, scene.num_pixels, (128,), generator=g,
                              device=device, dtype=torch.int32)
                for _ in range(156)]
    f32 = scene.padded_pca
    bf16 = f32.to(torch.bfloat16)
    # the bf16 trainers' pool: kernel 2 over the bf16 cube, bitwise the
    # cast of kernel 1's f32 pool
    pool16 = gather_patches_bf16(bf16, pool, cols=cols, w=W)
    pool32 = gather_patches_f32(f32, pool, cols=cols, w=W)
    require(torch.equal(bits(pool16), bits(pool32.to(torch.bfloat16))),
            "bf16 pool != the bf16 cast of the f32 pool")
    del pool16, pool32
    emit({"phase": "train_gather", "case": "bf16 pool vs cast f32 pool",
          "bitwise_equal": True})
    report = {}
    for name, wrapper, cube, cases in (
            ("patch_gather_f32", gather_patches_f32, f32,
             {"pool B=10240": [pool], "step B=128": step_ids}),
            ("patch_gather_bf16", gather_patches_bf16, bf16,
             {"pool B=10240": [pool], "step B=128": step_ids})):
        for label, ids in cases.items():
            got = wrapper(cube, ids[0], cols=cols, w=W)
            want = gather_patches(cube, ids[0], cols=cols, w=W)
            torch.cuda.synchronize()
            require(got.shape == want.shape == (ids[0].shape[0], W, W, N_PC),
                    f"{name} {label}: shape")
            require(torch.equal(bits(got), bits(want)),
                    f"{name} {label}: not bitwise equal to the plain gather")
            err = float((got.float() - want.float()).abs().max())
            del got, want
            times = gather_times(wrapper, cube, ids, cols, rounds=5)
            report.setdefault(name, {})[label] = {"max_abs_err": err,
                                                   "launches_timed": len(ids),
                                                   **times}
            emit({"phase": "train_gather", "kernel": name, "case": label,
                  "bitwise_equal": True, **report[name][label]})
    return report


def weights_and_adams(state):
    """([(weight, the Adam that holds its moments)], the most Adams that
    step one weight) of a trainer state: one for the two-net trainers; two
    for CCT, whose encoder both of its Adams step."""
    if hasattr(state, "net_b"):
        return [(p, net.opt) for net in (state.net_b, state.net_e)
                for p in net.model.parameters()], 1
    base = {id(p) for p in state.opt_base.param_groups[0]["params"]}
    return [(p, state.opt_base if id(p) in base else state.opt_aug)
            for p in state.model.parameters()], 2


def phase_card_vs_cpu(cube, gt, device, algo: str, flags_at_start,
                      compute_dtype: str = "float32", f32_grads=None):
    """Steps of ``algo``'s trainer from one state on the card and on the
    CPU, pool mode, full width, noise 0, dropout 0: the losses, the first
    step's gradients and the updated params agree.  f32: 3 steps, TF32 off
    inside the step; bf16: 1 step, with bf16's tolerances, its gradients
    held against ``f32_grads``, the (card, CPU) step-1 gradients of the
    f32 phase.  Returns the (card, CPU) step-1 gradients."""
    from cmlpl_tpu_torch.data.prep import prepare_scene
    from cmlpl_tpu_torch.train import CCTTrainer, CMLPLTrainer, CPSTrainer
    from cmlpl_tpu_torch.train.state import CMLPLConfig

    trainer_cls = {"cmlpl": CMLPLTrainer, "cps": CPSTrainer,
                   "cct": CCTTrainer}[algo]
    bf16 = compute_dtype == "bfloat16"
    steps = 1 if bf16 else 3
    cfg = CMLPLConfig(noise=0.0, dropout=0.0, gather_impl="pool",
                      compute_dtype=compute_dtype)
    li, ly, ui = (a[0, :steps] for a in default_schedule(
        gt.reshape(-1).astype(np.int32), 1))

    def run(dev):
        t0 = time.perf_counter()
        scene = prepare_scene(DATA_ID, cube=cube, gt=gt, patch_size=W,
                              n_pc=N_PC, device=dev)
        trainer = trainer_cls(cfg, device=dev)
        state = trainer.init_state(SEED)
        weights, adams = weights_and_adams(state)
        # step 1, then steps 2-3 (the same run as one 3-step call)
        state, m = trainer.train_epoch(state, scene, li[:1], ly[:1], ui[:1],
                                       epoch=1)
        grads = [p.grad.cpu().clone() for p, _ in weights]
        if steps > 1:
            state, m23 = trainer.train_epoch(state, scene, li[1:], ly[1:],
                                             ui[1:], epoch=1)
            m = {k: torch.cat([m[k], m23[k]]) for k in m}
        require(tf32_flags() == flags_at_start,
                f"the trainer left TF32 at {tf32_flags()}")
        params = [p.detach().cpu().clone() for p, _ in weights]
        # each weight's gradient RMS: Adam's bias-corrected second moment
        rms = [(opt.state[p]["exp_avg_sq"].cpu()
                / (1 - opt.defaults["betas"][1]
                   ** float(opt.state[p]["step"]))).sqrt()
               for p, opt in weights]
        return ({k: v.cpu().numpy() for k, v in m.items()},
                grads, params, rms, adams, time.perf_counter() - t0)

    (mc, gc, pc, rms_c, adams, card_s), (mh, gh, ph, rms, _, cpu_s) = (
        run(device), run(torch.device("cpu")))
    loss_err = {k: float(np.abs(mc[k] - mh[k]).max()) for k in mc}
    grad_err = grad_gap(gc, gh)
    # bf16's own move of the step-1 gradients, on each device
    bf16_move = ({"card": grad_gap(gc, f32_grads[0]),
                  "cpu": grad_gap(gh, f32_grads[1])} if bf16 else None)
    param_err, tight_ok = param_gap(
        [(a - b).abs().max() for a, b in zip(gc, gh)], pc, ph, rms, rms_c,
        adams, cfg.lr)
    name = "train" if algo == "cmlpl" else f"train_{algo}"
    emit({"phase": f"{name}_card_vs_cpu" + ("_bf16" if bf16 else ""),
          "steps": steps, "gather": "pool", "compute_dtype": compute_dtype,
          "losses_card": {k: mc[k].tolist() for k in mc},
          "losses_cpu": {k: mh[k].tolist() for k in mh},
          "max_abs_diff": loss_err,
          "step1_grad_max_diff_of_tensor_max": grad_err,
          "step1_grad_bf16_vs_f32_of_tensor_max": bf16_move,
          "params_max_abs_diff": param_err,
          "card_s": card_s, "cpu_s": cpu_s})
    for k in mc:
        require(np.all(np.isfinite(mc[k])), f"{algo}: card {k} not finite")
    require(param_err["no_gradient_max_abs_diff"] == 0,
            f"{algo}: a weight with no gradient moved: {param_err}")
    if bf16:
        for k in set(mc) - set(BF16_DECISIONS):
            require(np.allclose(mc[k], mh[k], rtol=BF16_LOSS_RTOL,
                                atol=BF16_LOSS_ATOL),
                    f"{algo} bf16: card vs CPU {k}: {mc[k]} vs {mh[k]}")
        require(grad_err <= BF16_GRAD_FACTOR * max(bf16_move.values()),
                f"{algo} bf16: card vs CPU step-1 gradients: {grad_err} of "
                f"the tensor's max; bf16 vs f32: {bf16_move}")
        # Adam's first step: lr times the gradient's sign, from each Adam
        require(param_err["max_abs_diff"] <= 2 * adams * cfg.lr + 1e-6,
                f"{algo} bf16: card vs CPU params: {param_err}")
        require(param_err["beyond_half_lr"]
                <= BF16_FLIPPED_MAX_SHARE * param_err["weights"],
                f"{algo} bf16: too many weights stepped the other way: "
                f"{param_err}")
        return gc, gh
    require_f32_steps(algo, mc, mh, grad_err, param_err, tight_ok, adams,
                      cfg.lr, steps)
    return gc, gh


def param_gap(gaps, pc, ph, rms, rms_c, adams: int, lr: float,
              rounding_only=None):
    """(report, held) of card-vs-CPU params ``pc``/``ph`` after f32 steps
    from one state, given each tensor's card-vs-CPU gradient gap (its
    largest difference) and each weight's gradient RMS (Adam's
    bias-corrected second moment) on each device: ``held`` is True when
    every well-conditioned weight lies within half of its step (see
    CARD_CPU_PARAM_*).  The weights of the tensors flagged in
    ``rounding_only`` (an exact gradient of 0) are held to Adam's reach
    alone and left out of the share held so."""
    rounding_only = rounding_only or [False] * len(pc)
    # weights with no gradient in any step on either side (a head's
    # columns whose features are 0 on every row) never move: held equal
    still = [(r == 0) & (q == 0) for r, q in zip(rms, rms_c)]
    well = [(r > ILL_CONDITIONED * gap) | z
            for r, gap, z in zip(rms, gaps, still)]
    diff = [(a - b).abs() for a, b in zip(pc, ph)]

    def worst(parts):
        return max((float(p.max()) for p in parts if p.numel()), default=0.0)

    # within half of the weight's step, whatever its gradient
    tight = [(a - b).abs() <= CARD_CPU_PARAM_ATOL * adams
             + CARD_CPU_PARAM_RTOL * b.abs() for a, b in zip(pc, ph)]
    report = {
        "max_abs_diff": worst(diff),
        "well_conditioned": worst(d[m] for d, m in zip(diff, well)),
        "ill_conditioned": worst(d[~m] for d, m in zip(diff, well)),
        "ill_conditioned_weights": int(sum(int((~m).sum()) for m in well)),
        "held_to_adams_reach": int(sum(int((~m & ~t).sum())
                                       for m, t, r in zip(well, tight,
                                                          rounding_only)
                                       if not r)),
        "rounding_only_weights": int(sum(d.numel() for d, r in zip(
            diff, rounding_only) if r)),
        "beyond_half_lr": int(sum(int((d > lr / 2).sum()) for d in diff)),
        "no_gradient_weights": int(sum(int(z.sum()) for z in still)),
        "no_gradient_max_abs_diff": worst(d[z] for d, z in zip(diff, still)),
        "weights": int(sum(d.numel() for d in diff)),
        "above_1e-5": int(sum(int((d > 1e-5).sum()) for d in diff))}
    return report, all(t[m].all() for t, m in zip(tight, well))


def require_f32_steps(what: str, mc, mh, grad_err, param_err, held: bool,
                      adams: int, lr: float, steps: int) -> None:
    """The f32 card-vs-CPU holds: losses, step-1 gradients, params."""
    for k in mc:
        require(np.allclose(mc[k], mh[k], rtol=CARD_CPU_LOSS_RTOL,
                            atol=CARD_CPU_LOSS_ATOL),
                f"{what}: card vs CPU {k}: {mc[k]} vs {mh[k]}")
    require(grad_err <= CARD_CPU_GRAD_TOL,
            f"{what}: card vs CPU step-1 gradients {grad_err} apart")
    require(held, f"{what}: card vs CPU params: {param_err}")
    # Adam's reach: up to lr a step on either side, from each Adam that
    # steps the weight (CCT's encoder takes two: 3 * 2 * 2 * lr)
    require(param_err["ill_conditioned"] <= steps * 2 * adams * lr,
            f"{what}: card vs CPU params beyond Adam's reach: {param_err}")
    require(param_err["held_to_adams_reach"]
            <= ILL_CONDITIONED_MAX_SHARE * param_err["weights"],
            f"{what}: card vs CPU: too many weights held only to Adam's "
            f"reach: {param_err}")


def grad_gap(got, want) -> float:
    """The largest difference of two gradient lists, each tensor's over its
    largest entry."""
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(got, want))


def train_cli_run(main_fn, tmp, name: str, counter_fn, maps, extra=(),
                  epochs: int = TRAIN_EPOCHS):
    """``main_fn`` (a training CLI's main) at full width on dataID 1 (the
    .mat is absent: the synthetic PaviaU scene) with the defaults but
    ``epochs`` and the flags ``extra``, and ``--metrics_csv``; the gather
    counts reset first.  Returns (its result, its report), after checking
    the step count, that the history is finite and, over more than one
    epoch, that the last epoch's mean cls_loss is below the first's."""
    from cmlpl_tpu_torch.ops.patch_gather import WRAPPERS

    os.makedirs(tmp, exist_ok=True)
    metrics = os.path.join(tmp, f"{name}_metrics.csv")
    argv = ["--dataID", str(DATA_ID), "--data_root", tmp,
            "--save_path_prefix", tmp, "--num_epochs", str(epochs),
            "--metrics_csv", metrics, *extra]
    for wrapper in WRAPPERS:
        wrapper.launches = 0
    result, lines, counts = run_cli(main_fn, argv + [
        "--weights_out", os.path.join(tmp, f"{name}.npz")], counter_fn)
    total = counter_fn()
    train_s, train_launches = line_value(lines, counts, "training time")
    # each map's launches: the counts at its timing line less those at the
    # line before it (training's, then the previous map's)
    per_map, before = {}, train_launches
    for m in maps:
        _, at = line_value(lines, counts, f"full-scene inference time ({m})")
        per_map[m] = {"gather_patches_f32": at[0] - before[0],
                      "gather_patches_bf16": at[1] - before[1]}
        before = at
    steps = epochs * 78
    require(f"({steps} steps)" in next(ln for ln in lines
                                       if ln.startswith("training time")),
            f"{name}: step count")
    hist = read_history(metrics)
    require(all(np.isfinite(v).all() for v in hist.values()),
            f"{name}: a training metric is not finite")
    cls = hist["cls_loss"].reshape(epochs, 78).mean(axis=1)
    require(epochs == 1 or cls[-1] < cls[0],
            f"{name}: cls_loss by epoch {cls}")
    return result, {
        "epochs": epochs, "steps": steps, "flags": list(extra),
        "train_s": train_s, "ms_per_step": train_s / steps * 1e3,
        "train_patches_per_s": steps * (128 + 128) / train_s,
        "map_s": {m: line_value(lines, counts,
                                f"full-scene inference time ({m})")[0]
                  for m in maps},
        "launches_training": {"gather_patches_f32": train_launches[0],
                              "gather_patches_bf16": train_launches[1]},
        "launches_with_maps": {"gather_patches_f32": total[0],
                               "gather_patches_bf16": total[1]},
        "launches_per_map": per_map,
        "cls_loss_by_epoch": cls.tolist(),
        "last_epoch_mean": {k: float(v[-78:].mean()) for k, v in hist.items()
                            if k != "step"}}


def profile_window(window) -> dict:
    """``window(lo)`` runs 20 steps from step ``lo``: one pass from 5 under
    the profiler, one from 25 on the host clock for the idle share."""
    dev_ms, calls, prof_wall_ms = profiled(window, [(5,)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window(25)
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(dev_ms.values())
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:10]
    # kernels whose names say they take bf16 operands (cuBLAS/cuDNN
    # tensor-core GEMMs and convolutions name their input type)
    bf16_ms = sum(v for k, v in dev_ms.items() if "bf16" in k.lower())
    # a device-bound window: the profiler lengthens kernels, so its busy
    # time can pass the unprofiled wall; the profiled window's own share
    # is then the one to read
    return {"steps": 20, "wall_ms_unprofiled": window_ms,
            "wall_ms_profiled": prof_wall_ms, "device_busy_ms": busy_ms,
            "device_busy_ms_per_step": busy_ms / 20,
            "device_idle_share": 1 - busy_ms / window_ms,
            "device_idle_share_profiled": 1 - busy_ms / prof_wall_ms,
            "bf16_named_kernels_ms": bf16_ms,
            "top_device_ops_ms": [{"name": k[:110], "ms": v,
                                   "calls": calls[k]} for k, v in top]}


def profiled_window(trainer, tscene) -> dict:
    """A profiled window of 20 default-schedule steps (after 5 unprofiled
    ones), and the same window unprofiled for the idle share."""
    state = trainer.init_state(SEED)
    li, ly, ui = (a[0] for a in default_schedule(tscene.labels, 1))
    trainer.train_epoch(state, tscene, li[:5], ly[:5], ui[:5], 1)
    return profile_window(lambda lo: trainer.train_epoch(
        state, tscene, li[lo:lo + 20], ly[lo:lo + 20], ui[lo:lo + 20], 1))


def accuracy(acc) -> dict:
    return {"oa": acc.oa, "aa": acc.aa, "kappa": acc.kappa}


def phase_train(tmp, cube, tscene, counter_fn):
    """cli.train.main at full width with its default pool gather, a
    profiled window of its steps, and serve with the written weights.
    Returns (its training launches, its net B OA and ms_per_step)."""
    from cmlpl_tpu_torch.cli import serve
    from cmlpl_tpu_torch.cli import train as cli_train
    from cmlpl_tpu_torch.cli._common import logits_fn
    from cmlpl_tpu_torch.data.prep import prepare_scene
    from cmlpl_tpu_torch.eval.inference import ScenePredictor
    from cmlpl_tpu_torch.eval.visualize import save_class_map
    from cmlpl_tpu_torch.models.basenet import BaseNet2
    from cmlpl_tpu_torch.train.cmlpl import CMLPLTrainer
    from cmlpl_tpu_torch.train.state import CMLPLConfig
    from cmlpl_tpu_torch.weights import load_params_npz, state_dict_from_jax

    (acc_b, acc_e), report = train_cli_run(cli_train.main, tmp, "cmlpl",
                                           counter_fn, ("net B", "net E"))
    # one pool gather per run, no bf16; each PaviaU map adds 406 launches
    launches = report["launches_training"]["gather_patches_f32"]
    require((launches, report["launches_training"]["gather_patches_bf16"])
            == (1, 0), f"training launches {report['launches_training']}")
    require(report["launches_with_maps"] == {
        "gather_patches_f32": 1 + 2 * 406, "gather_patches_bf16": 0},
        f"launches with the maps {report['launches_with_maps']}")
    require(acc_b.oa > 0.5 and acc_e.oa > 0.5,
            f"OA net B {acc_b.oa}, net E {acc_e.oa}")
    window = profiled_window(CMLPLTrainer(CMLPLConfig(),
                                          device=tscene.device), tscene)

    # serve one request with the written weights: their map on the host's
    # prep is the CLI's net B map, and serve's (on the card's prep) is
    # that map up to ties
    scene_npy = os.path.join(tmp, "paviau.npy")
    np.save(scene_npy, cube)
    weights = os.path.join(tmp, "cmlpl.npz")
    served_npy = os.path.join(tmp, "served_trained.npy")
    stdout = io.StringIO()
    serve.main(["--dataID", str(DATA_ID), "--n_PC", str(N_PC), "--w", str(W),
                "--val_batch_size", str(TILE), "--weights", weights,
                "--data_root", tmp, "--no_warmup"],
               stdin=io.StringIO(json.dumps({"id": "trained",
                                             "cube": scene_npy,
                                             "out": served_npy}) + "\n"),
               stdout=stdout)
    response = json.loads(stdout.getvalue().splitlines()[-1])
    require("error" not in response, f"serve error {response}")
    model = BaseNet2(num_features=cube.shape[-1], num_classes=9, n_pc=N_PC,
                     patch_size=W)
    model.load_state_dict(state_dict_from_jax(load_params_npz(weights)))
    apply = logits_fn(model.to(tscene.device).eval())
    card_scene = prepare_scene(DATA_ID, cube=cube, gt=np.zeros(
        cube.shape[:2], np.int64), patch_size=W, n_pc=N_PC,
        device=tscene.device, on_card=True)
    host_map, card_map = (ScenePredictor(
        apply, patch_size=W, cols=tscene.cols, tile=TILE,
        gather="pallas")(sc) for sc in (tscene, card_scene))
    host_svg = os.path.join(tmp, "weights_host_prep.svg")
    save_class_map(host_svg, host_map + 1, DATA_ID, rows=tscene.rows,
                   cols=tscene.cols)
    cli_svg = os.path.join(tmp, f"Experiment_{DATA_ID}", "label_5",
                           f"CMLPL_OA_{int(acc_b.oa * 10000)}.svg")
    with open(cli_svg, "rb") as a, open(host_svg, "rb") as b:
        require(a.read() == b.read(),
                "the written weights' map != the CLI's net B map")
    served_vs_host = hold_served(np.load(served_npy), card_map, host_map,
                                 tiled_logits(apply, tscene),
                                 "served trained map")

    emit({"phase": "train", **report,
          "accuracy": {"net_b": accuracy(acc_b), "net_e": accuracy(acc_e)},
          "served_map_equals_cli_map_up_to_ties": True,
          "served_vs_cli_map_differing_pixels": served_vs_host,
          "serve_latency_s": response["latency_s"],
          "profiled_window": window,
          "note": "synthetic PaviaU-size scene substituted for the absent "
                  ".mat; OA says the run learns, not how well on PaviaU"})
    return launches, {"oa": acc_b.oa, "ms_per_step": report["ms_per_step"]}


def phase_train_algo(tmp, tscene, counter_fn, algo: str):
    """cli.train_cps or cli.train_cct at full width with the default
    20-epoch schedule and pool gather: one f32 launch in training, 406 a
    map (two maps for CPS, one for CCT), no bf16; then a profiled window
    of its steps."""
    from cmlpl_tpu_torch.cli import train_cct, train_cps
    from cmlpl_tpu_torch.train import CCTTrainer, CPSTrainer
    from cmlpl_tpu_torch.train.state import CMLPLConfig

    main_fn, trainer_cls, maps = {
        "cps": (train_cps.main, CPSTrainer, ("net B", "net E")),
        "cct": (train_cct.main, CCTTrainer, ("CCT",))}[algo]
    result, report = train_cli_run(main_fn, os.path.join(tmp, algo), algo,
                                   counter_fn, maps)
    launches = report["launches_training"]["gather_patches_f32"]
    require((launches, report["launches_training"]["gather_patches_bf16"])
            == (1, 0), f"{algo}: training launches "
            f"{report['launches_training']}")
    require(report["launches_with_maps"] == {
        "gather_patches_f32": 1 + len(maps) * 406, "gather_patches_bf16": 0},
        f"{algo}: launches with the maps {report['launches_with_maps']}")
    accs = result if algo == "cps" else (result,)
    window = profiled_window(trainer_cls(CMLPLConfig(),
                                         device=tscene.device), tscene)
    emit({"phase": f"train_{algo}", **report,
          "accuracy": {m: accuracy(a) for m, a in zip(maps, accs)},
          "profiled_window": window,
          "note": "synthetic PaviaU-size scene substituted for the absent "
                  ".mat; OA says the run learns, not how well on PaviaU"})
    return launches


def phase_train_pallas(tmp, counter_fn):
    """One epoch at full width with each per-step kernel gather: 78 steps,
    two launches each, counted over the training part.  An "auto" whose
    pool is over the budget resolves to the f32 kernel per step."""
    from cmlpl_tpu_torch.cli import train as cli_train
    from cmlpl_tpu_torch.ops.patch_gather import WRAPPERS
    from cmlpl_tpu_torch.train.cmlpl import CMLPLTrainer
    from cmlpl_tpu_torch.train.state import CMLPLConfig

    # 60,000 unlabeled: a 5.8 GB pool, over the 2 GiB budget
    over = CMLPLTrainer(CMLPLConfig(num_unlabel=60000),
                        device="cuda").config.gather_impl
    require(over == "pallas", f"auto over the pool budget -> {over!r}")
    out = {"auto_over_budget": over}
    for gather, want in (("pallas", (156, 0)), ("pallas_bf16", (0, 156))):
        metrics = os.path.join(tmp, f"metrics_{gather}.csv")
        for wrapper in WRAPPERS:
            wrapper.launches = 0
        _, lines, counts = run_cli(cli_train.main, [
            "--dataID", str(DATA_ID), "--data_root", tmp,
            "--save_path_prefix", os.path.join(tmp, gather),
            "--num_epochs", "1", "--gather_impl", gather,
            "--metrics_csv", metrics], counter_fn)
        train_s, launches = line_value(lines, counts, "training time")
        require(launches == want,
                f"{gather}: training launches (f32, bf16) {launches}")
        hist = read_history(metrics)
        require(all(np.isfinite(v).all() for v in hist.values()),
                f"{gather}: a training metric is not finite")
        out[gather] = {"train_s": train_s, "ms_per_step": train_s / 78 * 1e3,
                       "launches_training": launches,
                       "launches_with_maps": counter_fn(),
                       "cls_loss_first_last": [hist["cls_loss"][0],
                                               hist["cls_loss"][-1]]}
    emit({"phase": "train_pallas", **out})
    return out


def verdict(ref: dict, ours: dict) -> dict:
    """Mean-overlap check of ``scripts/reference_oracle.py:362-386``:
    |mean diff| within two sigmas of the difference of means (floored at
    1.0 OA point), pooling both nets' OA."""
    r = np.array(ref["oa_a"] + ref["oa_b"])
    o = np.array(ours["oa_a"] + ours["oa_b"])
    if min(len(r), len(o)) < 2:
        return {"ref_n": int(len(r)), "ours_n": int(len(o)),
                "overlapping": None,
                "error": "need >=2 OA values per side for a verdict"}
    se = float(np.sqrt(r.var(ddof=1) / len(r) + o.var(ddof=1) / len(o)))
    diff = float(o.mean() - r.mean())
    band = max(2.0 * se, 1.0)
    return {
        "ref_mean_oa": round(float(r.mean()), 2),
        "ref_std_oa": round(float(r.std()), 2),
        "ours_mean_oa": round(float(o.mean()), 2),
        "ours_std_oa": round(float(o.std()), 2),
        "mean_diff": round(diff, 2),
        "band": round(band, 2),
        "overlapping": bool(abs(diff) <= band),
    }


def ab_inputs(tmp):
    """The oracle's A/B scene and splits (``scripts/reference_oracle.py:
    342-344,404-409``: the hard 64x48 synthetic scene of the paviau
    geometry, i.e. the 9-class, 103-band synthetic spec 0), written as the
    CLIs read them.  Returns (the splits directory, the scene npz)."""
    from cmlpl_tpu_torch.data.io import synthetic_scene
    from cmlpl_tpu_torch.data.splits import generate_splits, load_splits

    cube, gt = synthetic_scene(0, rows=64, cols=48, noise_std=1.2,
                               class_sep=0.35)
    ab = os.path.join(tmp, "ab")
    os.makedirs(ab)
    scene_npz = os.path.join(ab, "scene.npz")
    np.savez(scene_npz, cube=cube, gt=gt)
    # the oracle materialises its splits with cli/sample_generation.py,
    # i.e. generate_splits(gt, num_label=5); write those and read them back
    splits = generate_splits(np.asarray(gt).reshape(-1), num_label=5)
    for name, arr in (("train", splits.train), ("test", splits.test),
                      ("unlabel", splits.unlabeled)):
        np.save(os.path.join(ab, f"{name}_array.npy"), arr)
    back = load_splits(ab)
    require(all(np.array_equal(getattr(back, k), getattr(splits, k))
                for k in ("train", "test", "unlabeled")), "splits differ")
    return ab, scene_npz


def phase_ab(ab, scene_npz, algo: str, extra=(), phase=None):
    """OA of ``algo``'s CLI (with the flags ``extra``) vs the reference's
    own PyTorch code on the hard synthetic scene
    (``docs/<algo>_ref_seeds_r4.json``, seeds 1088..1099): ours at the
    first AB_SEEDS of them, the oracle's scene, splits and flags
    (``scripts/reference_oracle.py:297-317``: the same for the three
    CLIs).  CCT has one net, so its ``oa_b`` is empty;
    its reference spread is wide (sd 3.87), so its gate is the verdict's
    two standard errors where that is above AB_MAX_DIFF."""
    from cmlpl_tpu_torch.cli import train, train_cct, train_cps

    main_fn = {"cmlpl": train.main, "cps": train_cps.main,
               "cct": train_cct.main}[algo]
    with open(os.path.join(ROOT, "docs", f"{algo}_ref_seeds_r4.json")) as f:
        ref = json.load(f)[algo]["reference"]
    ours = {"oa_a": [], "oa_b": [], "sec_per_seed": []}
    for s in range(AB_SEEDS):
        t0 = time.perf_counter()
        result, _, _ = run_cli(main_fn, [
            "--dataID", "0", "--n_PC", "60", "--w", "20",
            "--scene_npz", scene_npz, "--splits_dir", ab,
            "--num_label", "5", "--num_epochs", "10",
            "--labeled_batch_size", "64", "--unlabeled_batch_size", "64",
            "--num_unlabel", "2048", "--val_batch_size", "512",
            "--dropout", "0.8", "--lr", "0.0005", "--print_per_batches", "0",
            "--seed", str(1088 + s), "--save_path_prefix", ab, *extra],
            lambda: None)
        ours["sec_per_seed"].append(time.perf_counter() - t0)
        accs = (result,) if algo == "cct" else result
        ours["oa_a"].append(accs[0].oa * 100)
        if algo != "cct":
            ours["oa_b"].append(accs[1].oa * 100)
    v = verdict(ref, ours)
    r = np.array(ref["oa_a"] + ref["oa_b"])
    o = np.array(ours["oa_a"] + ours["oa_b"])
    diff = float(o.mean() - r.mean())
    two_se = 2 * float(np.sqrt(r.var(ddof=1) / len(r)
                               + o.var(ddof=1) / len(o)))
    gate = max(AB_MAX_DIFF, two_se) if algo == "cct" else AB_MAX_DIFF
    require(abs(diff) <= gate,
            f"{algo}: mean OA {diff:+.2f} points from the reference's "
            f"(gate {gate:.2f})")
    emit({"phase": phase or ("train_ab" if algo == "cmlpl"
                             else f"{algo}_ab"), "flags": list(extra),
          "ours": ours, "verdict": v, "mean_diff_unrounded": diff,
          "two_se": two_se, "gate": gate})
    return v


def phase_train_bf16(tmp, tscene, counter_fn):
    """bf16 training at full width: cli.train with the default 20-epoch
    schedule, whose pool is kernel 2's (one launch, none of kernel 1; each
    map, f32-gathered, adds 406 of kernel 1), a profiled window of its
    steps, then one epoch each of cli.train_cps and cli.train_cct.
    Returns the bf16 pool launches of each."""
    from cmlpl_tpu_torch.cli import train as cli_train
    from cmlpl_tpu_torch.cli import train_cct, train_cps
    from cmlpl_tpu_torch.train.cmlpl import CMLPLTrainer
    from cmlpl_tpu_torch.train.state import CMLPLConfig

    bf16 = ["--compute_dtype", "bfloat16"]
    (acc_b, acc_e), report = train_cli_run(
        cli_train.main, os.path.join(tmp, "bf16"), "cmlpl_bf16", counter_fn,
        ("net B", "net E"), extra=bf16)
    require(report["launches_training"] == {"gather_patches_f32": 0,
                                            "gather_patches_bf16": 1},
            f"bf16 training launches {report['launches_training']}")
    require(report["launches_with_maps"] == {"gather_patches_f32": 2 * 406,
                                             "gather_patches_bf16": 1},
            f"bf16 launches with the maps {report['launches_with_maps']}")
    require(acc_b.oa > 0.5 and acc_e.oa > 0.5,
            f"bf16 OA net B {acc_b.oa}, net E {acc_e.oa}")
    window = profiled_window(CMLPLTrainer(
        CMLPLConfig(n_pc=N_PC, compute_dtype="bfloat16"),
        device=tscene.device), tscene)
    launches = {"cmlpl": 1}
    others = {}
    for algo, main_fn, maps in (("cps", train_cps.main, ("net B", "net E")),
                                ("cct", train_cct.main, ("CCT",))):
        _, rep = train_cli_run(main_fn, os.path.join(tmp, f"bf16_{algo}"),
                               f"{algo}_bf16", counter_fn, maps, extra=bf16,
                               epochs=1)
        require(rep["launches_training"] == {"gather_patches_f32": 0,
                                             "gather_patches_bf16": 1},
                f"{algo} bf16 training launches {rep['launches_training']}")
        launches[algo] = rep["launches_training"]["gather_patches_bf16"]
        others[algo] = rep
    emit({"phase": "train_bf16", **report,
          "accuracy": {"net_b": accuracy(acc_b), "net_e": accuracy(acc_e)},
          "profiled_window": window, "one_epoch": others,
          "note": "synthetic PaviaU-size scene substituted for the absent "
                  ".mat; OA says the run learns, not how well on PaviaU"})
    return launches


def phase_resume(tmp, counter_fn, device):
    """cli.train at full width, RESUME_EPOCHS epochs, a checkpoint an
    epoch, a fault injected after epoch FAIL_AT_EPOCH and one restart,
    through run_resilient: it completes from that epoch's checkpoint, and
    the pool is gathered once an epoch (kernel 1, RESUME_EPOCHS launches
    over both attempts).  Then the latest checkpoint restored on the card,
    saved again and restored again equals itself bit for bit, with its
    size and its save and restore times."""
    from cmlpl_tpu_torch.cli import train as cli_train
    from cmlpl_tpu_torch.cli._common import run_resilient
    from cmlpl_tpu_torch.ops.patch_gather import WRAPPERS
    from cmlpl_tpu_torch.train.cmlpl import CMLPLTrainer
    from cmlpl_tpu_torch.train.state import CMLPLConfig
    from cmlpl_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                  save_checkpoint)
    from cmlpl_tpu_torch.weights import _flatten

    ckpt = os.path.join(tmp, "resume_ckpt")
    argv = ["--dataID", str(DATA_ID), "--data_root", tmp,
            "--save_path_prefix", os.path.join(tmp, "resume"),
            "--num_epochs", str(RESUME_EPOCHS), "--checkpoint_dir", ckpt,
            "--checkpoint_every", "1", "--fail_at_epoch", str(FAIL_AT_EPOCH),
            "--max_restarts", "1"]
    for wrapper in WRAPPERS:
        wrapper.launches = 0
    t0 = time.perf_counter()
    (acc_b, _), lines, counts = run_cli(
        lambda a: run_resilient(cli_train.main, a), argv, counter_fn)
    wall_s = time.perf_counter() - t0
    text = "\n".join(lines)
    require("restart 1/1 from the latest checkpoint" in text,
            "resume: no restart reported")
    resumed_step = FAIL_AT_EPOCH * 78
    require(f"resumed from step {resumed_step} (epoch {FAIL_AT_EPOCH})"
            in text, "resume: not resumed from the injected epoch")
    train_s, launches = line_value(lines, counts, "training time")
    require(launches == (RESUME_EPOCHS, 0),
            f"resume: pool launches (f32, bf16) {launches}")
    steps = sorted(int(d) for d in os.listdir(ckpt) if d.isdigit())
    require(steps == [78 * e for e in range(1, RESUME_EPOCHS + 1)],
            f"resume: checkpoints {steps}")
    require(acc_b.oa > 0.3, f"resume: OA {acc_b.oa}")

    trainer = CMLPLTrainer(CMLPLConfig(n_pc=N_PC, num_epochs=RESUME_EPOCHS),
                           device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = restore_checkpoint(ckpt, trainer)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    again = os.path.join(tmp, "resume_again")
    t0 = time.perf_counter()
    path = save_checkpoint(again, trainer, state)
    save_ms = (time.perf_counter() - t0) * 1e3
    back = restore_checkpoint(again, trainer)
    a, b = (dict(_flatten(trainer.state_to_jax(x))) for x in (state, back))
    require(a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
        for k in a), "resume: the restored state differs from the saved")
    require(torch.equal(state.generator.get_state(),
                        back.generator.get_state()),
            "resume: the generator state differs")
    require(state.step == 78 * RESUME_EPOCHS, f"resume: step {state.step}")
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    emit({"phase": "resume", "epochs": RESUME_EPOCHS,
          "fail_at_epoch": FAIL_AT_EPOCH, "restarts": 1,
          "resumed_from_step": resumed_step, "checkpoints": steps,
          "train_s_after_restart": train_s, "wall_s": wall_s,
          "pool_launches_training": {"gather_patches_f32": launches[0],
                                     "gather_patches_bf16": launches[1]},
          "checkpoint_mb": size / 1e6, "save_ms": save_ms,
          "restore_ms": restore_ms, "restored_equals_saved_bitwise": True,
          "oa_net_b": acc_b.oa})
    return launches[0]


def phase_extras(tmp, tscene, counter_fn, device):
    """One full-width epoch of cli.train with each extra objective and with
    every augmentation; then one CMLPL step with stacked nets and one with
    two forwards from one state (noise and dropout off): the same losses
    and gradients within f32 rounding; and both step times with the
    default config (no claim).  Returns each epoch's report by label."""
    from cmlpl_tpu_torch.cli import train as cli_train
    from cmlpl_tpu_torch.train.cmlpl import METRICS, CMLPLTrainer
    from cmlpl_tpu_torch.train.state import CMLPLConfig

    runs = {}
    for label, extra in (
            ("memobank", ["--extra_loss", "memobank"]),
            ("mmd", ["--extra_loss", "mmd"]),
            ("ntxent", ["--extra_loss", "ntxent"]),
            ("augment", ["--augment", "flip", "rot90", "radiation",
                         "mixture"])):
        _, rep = train_cli_run(cli_train.main, os.path.join(tmp, label),
                               f"extras_{label}", counter_fn,
                               ("net B", "net E"), extra=extra, epochs=1)
        require(rep["launches_training"] == {"gather_patches_f32": 1,
                                             "gather_patches_bf16": 0},
                f"{label}: training launches {rep['launches_training']}")
        if label != "augment":
            require("extra_loss" in rep["last_epoch_mean"],
                    f"{label}: no extra_loss metric")
        runs[label] = {k: rep[k] for k in (
            "train_s", "ms_per_step", "last_epoch_mean", "launches_training")}

    li, ly, ui = (a[0] for a in default_schedule(tscene.labels, 1))
    out = {}
    for stack in (False, True):
        # the check: noise and dropout off, as card vs CPU
        trainer = CMLPLTrainer(CMLPLConfig(n_pc=N_PC, stack_nets=stack,
                                           noise=0.0, dropout=0.0),
                               device=device)
        state, m = trainer.train_epoch(trainer.init_state(SEED), tscene,
                                       li[:1], ly[:1], ui[:1], epoch=1)
        grads = [p.grad.detach().clone() for net in (state.net_b,
                                                     state.net_e)
                 for p in net.model.parameters()]
        # the times: the default config, 20 steps after 5
        trainer = CMLPLTrainer(CMLPLConfig(n_pc=N_PC, stack_nets=stack),
                               device=device)
        state = trainer.init_state(SEED)
        trainer.train_epoch(state, tscene, li[1:6], ly[1:6], ui[1:6], 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_epoch(state, tscene, li[6:26], ly[6:26], ui[6:26], 1)
        torch.cuda.synchronize()
        out[stack] = ({k: m[k].cpu().numpy() for k in m}, grads,
                      (time.perf_counter() - t0) / 20 * 1e3)
    (m0, g0, ms0), (m1, g1, ms1) = out[False], out[True]
    loss_err = {k: float(np.abs(m1[k] - m0[k]).max()) for k in METRICS}
    grad_err = grad_gap(g1, g0)
    for k in METRICS:
        require(np.allclose(m1[k], m0[k], rtol=STACK_LOSS_RTOL,
                            atol=STACK_LOSS_RTOL),
                f"stack_nets {k}: {m1[k]} vs {m0[k]}")
    require(grad_err <= STACK_GRAD_TOL,
            f"stack_nets: gradients {grad_err} of the tensor's max")
    emit({"phase": "extras", "one_epoch": runs,
          "stack_nets": {"loss_max_abs_diff": loss_err,
                         "grad_max_diff_of_tensor_max": grad_err,
                         "ms_per_step_two_forwards": ms0,
                         "ms_per_step_stacked": ms1, "steps_timed": 20}})
    return runs


def phase_dense(params, cube, scene, tiled_map, tiled_map_s: float):
    """Dense whole-scene eval at PaviaU width with the smoke's weights:
    ``predict --eval_gather dense`` launches no gather; the dense logits
    on the card agree with the same function's on the CPU, and so do the
    maps (tie-safe); the dense map's time beside the tiled one's, and the
    share of pixels where the two maps agree (reported: the weights are
    random, and the two differ by design near patch borders)."""
    from cmlpl_tpu_torch.cli import predict
    from cmlpl_tpu_torch.data.prep import prepare_scene
    from cmlpl_tpu_torch.eval.inference import (ScenePredictor,
                                                dense_scene_logits)
    from cmlpl_tpu_torch.ops.patch_gather import WRAPPERS
    from cmlpl_tpu_torch.weights import save_params_npz, state_dict_from_jax

    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "w.npz")
        save_params_npz(weights, params)
        for wrapper in WRAPPERS:
            wrapper.launches = 0
        t0 = time.perf_counter()
        pred = predict.main([
            "--dataID", str(DATA_ID), "--n_PC", str(N_PC), "--w", str(W),
            "--weights", weights, "--data_root", tmp, "--eval_gather",
            "dense", "--out", os.path.join(tmp, "dense.svg")])
        predict_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in WRAPPERS}
    require(not any(launches.values()), f"dense launched {launches}")

    sd_cpu = state_dict_from_jax(params)
    sd_card = {k: v.to(scene.device) for k, v in sd_cpu.items()}
    cpu_scene = prepare_scene(DATA_ID, cube=cube, gt=np.zeros(cube.shape[:2]),
                              patch_size=W, n_pc=N_PC, device="cpu")
    with torch.inference_mode():
        card = dense_scene_logits(sd_card, scene).cpu()
        cpu = dense_scene_logits(sd_cpu, cpu_scene)
    scale = float(cpu.abs().max())
    err = float((card - cpu).abs().max())
    require(card.shape == (scene.num_pixels, 9) and torch.isfinite(card).all(),
            f"dense logits {tuple(card.shape)}")
    require(torch.allclose(card, cpu, rtol=1e-4, atol=1e-4 * scale),
            f"dense card vs CPU: max diff {err}, max |logit| {scale}")
    cpu_map = cpu.argmax(-1).to(torch.int32).numpy()
    tie_safe_equal(card.argmax(-1).to(torch.int32).numpy(), cpu_map,
                   lambda ids: cpu[torch.from_numpy(ids)], "dense card vs CPU")
    tie_safe_equal(pred, cpu_map, lambda ids: cpu[torch.from_numpy(ids)],
                   "predict --eval_gather dense vs the CPU's dense map")

    predictor = ScenePredictor(None, params=sd_card, patch_size=W,
                               cols=scene.cols, gather="dense")
    predictor(scene)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense_map = predictor(scene)
    dense_map_s = time.perf_counter() - t0
    dev_ms, counts, prof_wall_ms = profiled(predictor, [(scene,)])
    busy_ms = sum(dev_ms.values())
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "dense", "predict_wall_s": predict_s,
          "gather_launches": launches, "logits_max_abs_diff_card_vs_cpu":
          err, "max_abs_logit": scale, "card_map_vs_cpu_map_differing_pixels":
          int((dense_map != cpu_map).sum()), "dense_map_s": dense_map_s,
          "tiled_map_s": tiled_map_s,
          "agreement_with_tiled_map": float((dense_map == tiled_map).mean()),
          "profiled_map": {"wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
                           "device_idle_share": 1 - busy_ms / prof_wall_ms,
                           "top_kernels_ms": [
                               {"name": k[:90], "ms": v, "calls": counts[k]}
                               for k, v in top]},
          "note": "random weights on the synthetic PaviaU-size scene"})


# --------------------------------------------------------------------------
# slice 5: the comparison zoo (cli.train_backbone)
# --------------------------------------------------------------------------

def zoo_shapes() -> dict:
    """{model: (w, n_pc)} of every ZOO entry at PaviaU width (its own
    defaults, -1 = all 103 bands)."""
    from cmlpl_tpu_torch.models.zoo import ZOO
    from cmlpl_tpu_torch.registry import get_dataset

    bands = get_dataset(DATA_ID).num_bands
    return {name: (e.default_patch,
                   bands if e.default_n_pc == -1 else e.default_n_pc)
            for name, e in ZOO.items()}


def phase_zoo_kernels(device):
    """Kernel 1 vs the plain gather, bitwise, at every (w, C) of the zoo
    at PaviaU width (610x340, cubes of random values, as the gather reads
    them): a map tile (B = 512; tile 123 and the ragged last) and a
    training step (B = 45, the labeled split); kernel 2 the same at (9,
    103); both kernels at every zoo (w, C)'s edges (``edge_cases``).  Then
    each site's times over a map's 406 tiles and 100 steps, as
    ``phase_kernels`` takes them, and each kernel's floor: its device time
    at B = 1 and (w, C) = FLOOR_SITE, with its bound and the library
    call's.  Returns (the sites' report, the floors' times)."""
    from cmlpl_tpu_torch.data.patches import gather_patches, patch_pad_width
    from cmlpl_tpu_torch.ops.patch_gather import (gather_patches_bf16,
                                                  gather_patches_f32)

    rows, cols = 610, 340
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    tiles = map_tiles(rows * cols, device)
    steps = [torch.randint(0, rows * cols, (ZOO_BATCH,), generator=g,
                           device=device, dtype=torch.int32)
             for _ in range(100)]
    sites = {}
    for name, shape in zoo_shapes().items():
        sites.setdefault(shape, []).append(name)
    report = {"patch_gather_f32": {}, "patch_gather_bf16": {}}
    floors = {}
    for (w, c), models in sites.items():
        hw = patch_pad_width(w)
        cube = torch.randn(rows + 2 * hw, cols + 2 * hw, c, generator=g,
                           device=device)
        for kname, wrapper, dtype in (
                ("patch_gather_f32", gather_patches_f32, torch.float32),
                ("patch_gather_bf16", gather_patches_bf16, torch.bfloat16)):
            cb = cube.to(dtype)
            check_edges(kname, wrapper, cb, cols, w, "zoo_kernels")
            if (w, c) == FLOOR_SITE:
                # the B = 1 floor beside its bound and the library call
                floors[kname] = gather_times(
                    wrapper, cb, [t[:1] for t in steps[:FLOOR_LAUNCHES]],
                    cols, w=w)
                emit({"phase": "zoo_kernels", "kernel": kname,
                      "floor": floors[kname], "site": f"B=1 w={w} C={c}"})
        kernels = [("patch_gather_f32", gather_patches_f32, cube)]
        if (w, c) == (9, 103):
            kernels.append(("patch_gather_bf16", gather_patches_bf16,
                            cube.to(torch.bfloat16)))
        for kname, wrapper, cb in kernels:
            for label, ids in ((f"zoo map tile B=512 w={w} C={c}", tiles),
                               (f"zoo step B={ZOO_BATCH} w={w} C={c}",
                                steps)):
                for t in (ids[123 % len(ids)], ids[-1]):
                    got = wrapper(cb, t, cols=cols, w=w)
                    want = gather_patches(cb, t, cols=cols, w=w)
                    torch.cuda.synchronize()
                    require(got.shape == want.shape == (t.shape[0], w, w, c)
                            and got.dtype == cb.dtype,
                            f"{kname} {label}: shape/dtype")
                    require(torch.equal(bits(got), bits(want)),
                            f"{kname} {label}: not bitwise equal to the "
                            "plain gather")
                times = gather_times(wrapper, cb, ids, cols, w=w)
                report[kname][label] = {"models": models, "max_abs_err": 0.0,
                                        "launches_timed": len(ids), **times}
                emit({"phase": "zoo_kernels", "kernel": kname,
                      "case": label, "bitwise_equal": True,
                      **report[kname][label]})
    require(set(floors) == set(report), f"floors of {sorted(floors)}")
    return report, floors


def phase_zoo_card_vs_cpu(cube, gt, device, flags_at_start) -> dict:
    """Each ZOO entry at its PaviaU-width shapes: ZOO_STEPS_CHECKED
    supervised steps of the labeled split (B = 45) from one state
    (``init_state(SEED)``: numpy draws, the same weights on both devices)
    on the card and on the CPU, BN in train mode.  Dropout draws its masks
    from one CPU generator per call, so SSFTT's and FDSSC's masks are the
    same on both.  Losses, step-1 gradients and params are held as
    ``phase_card_vs_cpu`` holds the trainers, BN statistics within
    ZOO_STATS_ATOL.  Returns the card scenes, by model, for ``zoo_train``."""
    import dataclasses

    from cmlpl_tpu_torch.data.prep import prepare_scene
    from cmlpl_tpu_torch.data.splits import generate_splits
    from cmlpl_tpu_torch.models import common
    from cmlpl_tpu_torch.models.zoo import build_model
    from cmlpl_tpu_torch.registry import get_dataset
    from cmlpl_tpu_torch.train.supervised import SupervisedTrainer, schedule

    spec = get_dataset(DATA_ID)
    labels = gt.reshape(-1).astype(np.int32)
    train = generate_splits(labels, num_label=5).train
    li, ly = schedule(train, labels, ZOO_BATCH, ZOO_STEPS_CHECKED, None,
                      1088)
    masks_drawn = []

    def same_mask(shape, rate, generator, dev):
        gen = torch.Generator().manual_seed(SEED + len(masks_drawn))
        masks_drawn.append(tuple(shape))
        return (torch.rand(shape, generator=gen) < 1.0 - rate).to(dev)

    def run(name, w, n_pc, scene):
        masks_drawn.clear()
        t0 = time.perf_counter()
        trainer = SupervisedTrainer(name, spec, patch_size=w, n_pc=n_pc,
                                    device=scene.device)
        state = trainer.init_state(SEED)
        params = list(state.model.parameters())
        losses, grads = [], []
        for i in range(ZOO_STEPS_CHECKED):
            state, m = trainer.train_step(state, scene, li[i], ly[i])
            losses.append(float(m["cls_loss"]))
            # BaseNet2Zoo's feature head has no gradient: CE reads only
            # the logits
            grads.append([torch.zeros(p.shape) if p.grad is None
                          else p.grad.cpu().clone() for p in params])
        rms = [(state.opt.state[p]["exp_avg_sq"].cpu()
                / (1 - 0.999 ** float(state.opt.state[p]["step"]))).sqrt()
               if p in state.opt.state else torch.zeros(p.shape)
               for p in params]
        return ({"cls_loss": np.array(losses)}, grads,
                [p.detach().cpu().clone() for p in params], rms,
                {k: v.cpu() for k, v in state.model.named_buffers()},
                trainer.gather_impl, list(masks_drawn),
                time.perf_counter() - t0)

    keep_mask = common.keep_mask
    common.keep_mask = same_mask
    scenes, out, holds = {}, {}, []
    try:
        for name, (w, n_pc) in zoo_shapes().items():
            # prepared once, on the CPU; the same tensors on the card
            cpu_scene = prepare_scene(DATA_ID, cube=cube, gt=gt,
                                      patch_size=w, n_pc=n_pc, device="cpu")
            scenes[name] = dataclasses.replace(
                cpu_scene, padded_pca=cpu_scene.padded_pca.to(device),
                spectra=cpu_scene.spectra.to(device))
            names = [k for k, _ in build_model(name, spec, n_pc, w)[0]
                     .named_parameters()]
            (mc, gc, pc, rms_c, st_c, impl_c, masks_c, card_s) = run(
                name, w, n_pc, scenes[name])
            (mh, gh, ph, rms, st_h, impl_h, masks_h, cpu_s) = run(
                name, w, n_pc, cpu_scene)
            # a conv bias that only train-mode BNs read has an exact
            # gradient of 0: both devices compute rounding, which no bound
            # can hold to each other; Adam's reach holds its weights
            top = max(float(g.abs().max()) for g in gh[0])
            noise = [0 < float(g.abs().max()) < ROUNDING_ONLY * top
                     for g in gh[0]]
            kept = [(a, b) for a, b, n in zip(gc[0], gh[0], noise) if not n]
            # each tensor's gap over its own largest entry (reported), and
            # over the model's largest gradient (held): the 3-D models'
            # BN reductions over 45x9x9x49 entries cancel, and the card's
            # f32 sums keep fewer digits of them than the CPU's (its f64
            # sums equal the CPU's to 1e-11)
            grad_err = max(float((a - b).abs().max()) for a, b in kept) / top
            tensor_err = grad_gap(*zip(*kept))
            # a weight's conditioning from its tensor's gradient gap over
            # all the steps: PAM's q/k/v convs have an exact gradient of 0
            # at step 1 (gamma starts at 0), not after it
            gaps = [max(float((a - b).abs().max()) for a, b in steps)
                    for steps in zip(*(zip(c, h) for c, h in zip(gc, gh)))]
            param_err, held = param_gap(gaps, pc, ph, rms, rms_c, 1, 5e-4,
                                        noise)
            stats_err = max((float((st_c[k] - st_h[k]).abs().max())
                             for k in st_h), default=0.0)
            out[name] = {"w": w, "n_pc": n_pc, "losses_card":
                         mc["cls_loss"].tolist(), "losses_cpu":
                         mh["cls_loss"].tolist(), "dropout_masks":
                         len(masks_c),
                         "step1_grad_max_diff_of_model_max": grad_err,
                         "step1_grad_max_diff_of_tensor_max": tensor_err,
                         "rounding_only_tensors": [
                             k for k, n in zip(names, noise) if n],
                         "params_max_abs_diff": param_err,
                         "batch_stats_max_abs_diff": stats_err,
                         "card_s": card_s, "cpu_s": cpu_s}
            emit({"phase": "zoo_card_vs_cpu", "model": name, **out[name]})
            holds.append((name, impl_c, impl_h, masks_c == masks_h,
                          tf32_flags(), mc, mh, grad_err, param_err, held,
                          st_c, st_h))
    finally:
        common.keep_mask = keep_mask
    # every model reported, then held
    for (name, impl_c, impl_h, same_masks, flags, mc, mh, grad_err,
         param_err, held, st_c, st_h) in holds:
        require((impl_c, impl_h) == ("pallas", "xla"),
                f"{name}: auto gather {impl_c} on the card, {impl_h} on the "
                "CPU")
        require(same_masks, f"{name}: dropout masks differ")
        require(flags == flags_at_start,
                f"{name}: the trainer left TF32 at {flags}")
        require(np.all(np.isfinite(mc["cls_loss"])),
                f"{name}: card loss not finite")
        require(param_err["no_gradient_max_abs_diff"] == 0,
                f"{name}: a weight with no gradient moved: {param_err}")
        require_f32_steps(name, mc, mh, grad_err, param_err, held, 1, 5e-4,
                          ZOO_STEPS_CHECKED)
        for k in st_h:
            require(torch.allclose(st_c[k], st_h[k],
                                   rtol=CARD_CPU_PARAM_RTOL,
                                   atol=ZOO_STATS_ATOL),
                    f"{name}: card vs CPU BN statistics {k}: "
                    f"{float((st_c[k] - st_h[k]).abs().max())}")
    return scenes


def zoo_window(name: str, scene) -> dict:
    """``profile_window`` of 20 supervised steps (B = 45) of ``name`` on
    ``scene``, after 5 unprofiled ones."""
    from cmlpl_tpu_torch.data.splits import generate_splits
    from cmlpl_tpu_torch.train.supervised import SupervisedTrainer

    trainer = SupervisedTrainer(name, scene.spec, patch_size=scene.patch_size,
                                n_pc=scene.n_pc, device=scene.device)
    train = generate_splits(scene.labels, num_label=5).train
    li, ly = trainer._schedule(train, scene.labels, ZOO_BATCH, 45, None, 1)
    state = trainer.init_state(SEED)
    trainer.train_run(state, scene, li[:5], ly[:5])
    return profile_window(lambda lo: trainer.train_run(
        state, scene, li[lo:lo + 20], ly[lo:lo + 20]))


def phase_zoo_train(tmp, scenes, counter_fn) -> dict:
    """``cli.train_backbone --dataID 1 --model <m> --num_epochs 100`` for
    every ZOO entry at its defaults (ZOO_EXTRA adds an EMA teacher, the
    augmentations and --epoch_samples to one model each): kernel 1 once a
    step in training ("auto" on the card), a map's tiles (406; two maps
    with the EMA teacher), kernel 2 never; the history finite, the last epoch's
    cls_loss below the first's; then a profiled window of 20 steps.
    Returns kernel 1's training launches by model."""
    from cmlpl_tpu_torch.cli import train_backbone
    from cmlpl_tpu_torch.ops.patch_gather import WRAPPERS

    launches, report = {}, {}
    for name, (w, n_pc) in zoo_shapes().items():
        extra = ZOO_EXTRA.get(name, [])
        metrics = os.path.join(tmp, f"zoo_{name}.csv")
        for wrapper in WRAPPERS:
            wrapper.launches = 0
        acc, lines, counts = run_cli(train_backbone.main, [
            "--dataID", str(DATA_ID), "--model", name, "--num_epochs",
            str(ZOO_EPOCHS), "--data_root", tmp, "--save_path_prefix",
            os.path.join(tmp, "zoo"), "--metrics_csv", metrics, *extra],
            counter_fn)
        total = counter_fn()
        train_s, in_training = line_value(lines, counts, "training time")
        steps = int(re.search(r"\((\d+) steps\)", next(
            ln for ln in lines if ln.startswith("training time"))).group(1))
        maps = [name] + ([f"{name} EMA teacher"]
                         if "--ema_teacher" in extra else [])
        map_s = {m: line_value(lines, counts,
                               f"full-scene inference time ({m})")[0]
                 for m in maps}
        per_epoch = steps // ZOO_EPOCHS
        tiles = -(-scenes[name].num_pixels // TILE)
        require(steps == ZOO_EPOCHS * (28 if "--epoch_samples" in extra
                                       else 1), f"{name}: {steps} steps")
        require(in_training == (steps, 0),
                f"{name}: training launches (f32, bf16) {in_training}")
        require(total == (steps + tiles * len(maps), 0),
                f"{name}: launches with the maps {total}")
        hist = read_history(metrics)
        require(all(np.isfinite(v).all() for v in hist.values()),
                f"{name}: a training metric is not finite")
        cls = hist["cls_loss"].reshape(ZOO_EPOCHS, per_epoch).mean(axis=1)
        require(cls[-1] < cls[0], f"{name}: cls_loss by epoch {cls[[0, -1]]}")
        launches[name] = in_training[0]
        report[name] = {
            "w": w, "n_pc": n_pc, "flags": extra, "steps": steps,
            "train_s": train_s, "ms_per_step": train_s / steps * 1e3,
            "map_s": map_s, "launches_training": in_training[0],
            "launches_maps": total[0] - in_training[0],
            "oa": acc.oa, "aa": acc.aa, "kappa": acc.kappa,
            "cls_loss_first_last_epoch": [float(cls[0]), float(cls[-1])],
            "profiled_window": zoo_window(name, scenes[name])}
        emit({"phase": "zoo_train", "model": name, **report[name]})
    emit({"phase": "zoo_train_summary", "models": {
        k: {f: v[f] for f in ("ms_per_step", "map_s", "oa")}
        | {"idle_share": v["profiled_window"]["device_idle_share"]}
        for k, v in report.items()},
        "note": "synthetic PaviaU-size scene substituted for the absent "
                ".mat; OA says the run learns, not how well on PaviaU"})
    return launches


def phase_zoo_ab(ab, scene_npz) -> None:
    """Mean OA of the port's ``cli.train_backbone`` on the card against
    the JAX package's bank (``docs/zoo_jax_seeds.json``,
    ``scripts/zoo_jax_seeds.py``): the same hard scene, splits and flags,
    and for each of ZOO_AB_MODELS the bank's seeds (from its first, as
    many as it holds for the model); |mean difference| within
    max(AB_MAX_DIFF, two standard errors)."""
    from cmlpl_tpu_torch.cli import train_backbone

    with open(os.path.join(ROOT, "docs", "zoo_jax_seeds.json")) as f:
        bank = json.load(f)
    out = {}
    for name in ZOO_AB_MODELS:
        ref = np.array(bank["models"][name]["oa"])
        ours, secs = [], []
        for s in range(len(ref)):
            t0 = time.perf_counter()
            acc, _, _ = run_cli(train_backbone.main, [
                *bank["port_cli_flags"], "--model", name, "--scene_npz",
                scene_npz, "--splits_dir", ab, "--save_path_prefix", ab,
                "--seed", str(bank["first_seed"] + s)], lambda: None)
            secs.append(time.perf_counter() - t0)
            ours.append(acc.oa * 100)
        o = np.array(ours)
        diff = float(o.mean() - ref.mean())
        two_se = 2 * float(np.sqrt(ref.var(ddof=1) / len(ref)
                                   + o.var(ddof=1) / len(o)))
        gate = max(AB_MAX_DIFF, two_se)
        out[name] = {"ours": ours, "ours_mean": float(o.mean()),
                     "jax_mean": float(ref.mean()), "jax_n": len(ref),
                     "mean_diff": diff, "two_se": two_se, "gate": gate,
                     "sec_per_seed": secs}
        emit({"phase": "zoo_ab", "model": name, **out[name]})
        require(abs(diff) <= gate,
                f"zoo_ab {name}: mean OA {diff:+.2f} points from JAX's "
                f"(gate {gate:.2f})")


def run_zoo(cube, gt, device, flags_at_start, counter_fn):
    """The slice-5 phases after the zoo's kernels (``phase_zoo_kernels``);
    returns kernel 1's training launches by model."""
    scenes = phase_zoo_card_vs_cpu(cube, gt, device, flags_at_start)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_zoo_train(tmp, scenes, counter_fn)
        del scenes
        phase_zoo_ab(*ab_inputs(tmp))
    require(tf32_flags() == flags_at_start,
            f"TF32 left at {tf32_flags()}, found at {flags_at_start}")
    return launches


# ---------------------------------------------------------------------------
# slice 7: data prep, serving from a checkpoint, profiling, fused seeds
# ---------------------------------------------------------------------------

def predict_map(argv, counter_fn):
    """``cli.predict`` on ``argv`` with the gather counts reset: (its map,
    the f32 and bf16 launches it made)."""
    from cmlpl_tpu_torch.cli import predict
    from cmlpl_tpu_torch.ops.patch_gather import WRAPPERS

    for wrapper in WRAPPERS:
        wrapper.launches = 0
    pred, _, _ = run_cli(predict.main, argv, counter_fn)
    return pred, counter_fn()


def phase_prep_train_serve(tmp, cube, gt, scene, counter_fn, device):
    """``cli.sample_generation`` of the synthetic PaviaU scene (its five
    files equal to the port's prep in process); ``cli.train`` on those
    splits for 2 epochs with ``--checkpoint_dir``, ``--weights_out`` and
    ``--profile_dir``, in a process of its own (the trace names the gather
    kernel); ``predict
    --checkpoint_dir`` of net B bitwise the map of ``--weights``, of net E
    that of ``ScenePredictor`` on net E's params, 406 kernel-1 launches a
    map; one ``serve --checkpoint_dir`` request; and ``XP.npy`` of the
    64x48 scene, written in more than one chunk, equal to the plain
    gather's patches.  Returns the kernel-1 launches (training, a map)."""
    from cmlpl_tpu_torch.cli import sample_generation, serve
    from cmlpl_tpu_torch.cli._common import logits_fn
    from cmlpl_tpu_torch.data.patches import gather_patches
    from cmlpl_tpu_torch.data.prep import feature_normalize, prepare_scene
    from cmlpl_tpu_torch.data.splits import generate_splits
    from cmlpl_tpu_torch.eval.inference import ScenePredictor
    from cmlpl_tpu_torch.models.basenet import BaseNet2
    from cmlpl_tpu_torch.utils.checkpoint import load_net_params
    from cmlpl_tpu_torch.weights import state_dict_from_jax

    os.makedirs(tmp, exist_ok=True)
    npz = os.path.join(tmp, "paviau.npz")
    np.savez(npz, cube=cube, gt=gt)
    t0 = time.perf_counter()
    _, lines, _ = run_cli(sample_generation.main, [
        "--dataID", str(DATA_ID), "--scene_npz", npz, "--data_root",
        os.path.join(tmp, "prep")], counter_fn)
    prep_s = time.perf_counter() - t0
    splits_dir = os.path.join(tmp, "prep", "PaviaU")
    flat = cube.reshape(-1, cube.shape[-1])
    y = gt.reshape(-1)
    splits = generate_splits(y, num_label=5)
    want = {"X.npy": feature_normalize(flat, 1).astype(np.float32),
            "Y.npy": y, "train_array.npy": splits.train,
            "test_array.npy": splits.test,
            "unlabel_array.npy": splits.unlabeled}
    for name, arr in want.items():
        got = np.load(os.path.join(splits_dir, name))
        require(got.dtype == arr.dtype and np.array_equal(got, arr),
                f"sample_generation {name} differs from the port's prep")

    # 2 epochs on those splits, traced, with a checkpoint and the weights,
    # in a process of its own as a user runs it (see slice7_in_child)
    ck = os.path.join(tmp, "ck")
    prof = os.path.join(tmp, "prof")
    acc, rep = traced_train_run(tmp, [
        "--splits_dir", splits_dir, "--scene_npz", npz, "--checkpoint_dir",
        ck, "--profile_dir", prof])
    require(rep["launches_training"] == {"gather_patches_f32": 1,
                                         "gather_patches_bf16": 0},
            f"profiled run: training launches {rep['launches_training']}")
    traces = [os.path.join(prof, f) for f in os.listdir(prof)
              if f.endswith(".json")]
    require(len(traces) == 1, f"traces {os.listdir(prof)}")
    with open(traces[0], "rb") as f:
        trace_bytes = f.read()
    require(KERNEL_NEEDLE.encode() in trace_bytes,
            "the trace names no patch-gather kernel")
    require(b"aten::convolution" in trace_bytes, "the trace has no conv")

    # maps from the checkpoint against the weights and net E's params
    common = ["--dataID", str(DATA_ID), "--n_PC", str(N_PC), "--w", str(W),
              "--val_batch_size", str(TILE), "--data_root", tmp]
    weights = os.path.join(tmp, "prep.npz")
    by_weights, n_w = predict_map(common + ["--weights", weights, "--out",
                                            os.path.join(tmp, "w.svg")],
                                  counter_fn)
    maps, launches = {}, {}
    for net in ("b", "e"):
        maps[net], launches[net] = predict_map(common + [
            "--checkpoint_dir", ck, "--net", net, "--out",
            os.path.join(tmp, f"{net}.svg")], counter_fn)
    require(n_w == launches["b"] == launches["e"] == (406, 0),
            f"predict launches {n_w}, {launches}")
    require(np.array_equal(maps["b"], by_weights),
            "predict --checkpoint_dir --net b != predict --weights")
    model = BaseNet2(num_features=cube.shape[-1], num_classes=9, n_pc=N_PC,
                     patch_size=W)
    model.load_state_dict(state_dict_from_jax(load_net_params(ck, "e")))
    model = model.to(device).eval()
    net_e = ScenePredictor(logits_fn(model), patch_size=W, cols=scene.cols,
                           tile=TILE, gather="pallas")(scene)
    require(np.array_equal(maps["e"], net_e),
            "predict --checkpoint_dir --net e != net E's ScenePredictor map")

    stdout = io.StringIO()
    scene_npy = os.path.join(tmp, "paviau.npy")
    np.save(scene_npy, cube)
    serve.main(common + ["--checkpoint_dir", ck, "--no_warmup"],
               stdin=io.StringIO(json.dumps({
                   "id": "ckpt", "cube": scene_npy,
                   "out": os.path.join(tmp, "served.npy")}) + "\n"),
               stdout=stdout)
    response = json.loads(stdout.getvalue().splitlines()[-1])
    require("error" not in response, f"serve error {response}")
    model.load_state_dict(state_dict_from_jax(load_net_params(ck, "b")))
    card_scene = prepare_scene(DATA_ID, cube=cube, gt=np.zeros(
        cube.shape[:2], np.int64), patch_size=W, n_pc=N_PC, device=device,
        on_card=True)
    net_b = ScenePredictor(logits_fn(model), patch_size=W, cols=scene.cols,
                           tile=TILE, gather="pallas")(card_scene)
    served_vs_predict = hold_served(
        np.load(os.path.join(tmp, "served.npy")), net_b, maps["b"],
        tiled_logits(logits_fn(model), scene),
        "serve --checkpoint_dir vs predict's net B map")

    # XP.npy of the 64x48 scene, in chunks, against the plain gather
    _, lines, _ = run_cli(sample_generation.main, [
        "--dataID", "0", "--n_PC", str(N_PC), "--w", str(W), "--data_root",
        os.path.join(tmp, "xp"), "--materialize_patches"], counter_fn)
    chunks = int(re.search(r"in (\d+) chunks", "\n".join(lines)).group(1))
    require(chunks > 1, f"XP.npy in {chunks} chunk")
    xp = np.load(os.path.join(tmp, "xp", "Synthetic", "XP.npy"))
    small = prepare_scene(0, patch_size=W, n_pc=N_PC, device=device)
    ids = torch.arange(small.num_pixels, dtype=torch.int32, device=device)
    plain = gather_patches(small.padded_pca, ids, cols=small.cols,
                           w=W).permute(0, 3, 1, 2).cpu().numpy()
    require(xp.shape == plain.shape and np.array_equal(xp, plain),
            "XP.npy != the plain gather's NCHW patches")
    emit({"phase": "prep_train_serve", "sample_generation_s": prep_s,
          "files_equal_port_prep": sorted(want),
          "train": {k: rep[k] for k in ("train_s", "ms_per_step",
                                        "launches_training",
                                        "launches_with_maps")},
          "accuracy": acc, "trace_mb": len(trace_bytes) / 2 ** 20,
          "trace_names_the_gather_kernel": True,
          "predict_launches": {"weights": n_w, **launches},
          "checkpoint_map_equals_weights_map": True,
          "net_e_map_equals_scene_predictor": True,
          "serve_latency_s": response["latency_s"],
          "served_vs_predict_differing_pixels": served_vs_predict,
          "xp_shape": list(xp.shape), "xp_chunks": chunks,
          "xp_equals_plain_gather": True,
          "note": "profiled run: its train_s includes the profiler"})
    return {"train": rep["launches_training"]["gather_patches_f32"],
            "map": launches["b"][0]}


SLICE7 = """
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
print(json.dumps(cs.run_slice7(sys.argv[2])), flush=True)
"""


def run_slice7(tmp) -> dict:
    """The slice-7 phases on the synthetic PaviaU scene; returns their
    launches and the fused pool's kernel report."""
    from cmlpl_tpu_torch.data.io import synthetic_scene
    from cmlpl_tpu_torch.data.prep import prepare_scene
    from cmlpl_tpu_torch.ops.patch_gather import (gather_patches_bf16,
                                                  gather_patches_f32)

    def counter_fn():
        return (gather_patches_f32.launches, gather_patches_bf16.launches)

    device = torch.device("cuda")
    cube, gt = synthetic_scene(DATA_ID)
    tscene = prepare_scene(DATA_ID, cube=cube, gt=gt, patch_size=W,
                           n_pc=N_PC, device=device)
    prep = phase_prep_train_serve(os.path.join(tmp, "prep"), cube, gt,
                                  tscene, counter_fn, device)
    fused = phase_fused(os.path.join(tmp, "fused"), tscene, counter_fn,
                        device)
    return {"prep": prep, "fused": fused}


def slice7_in_child(tmp) -> dict:
    """:func:`run_slice7` in a new process (the kernels built here), its
    phase lines printed here.  Processes of their own, this one and the
    traced run's: on the H100, torch.profiler in a process that has taken
    large traces loses the kernel records of later ones, the first few
    and then all (seen in this script's runs: a 2-epoch ``--profile_dir``
    run lost its pool gather after the profiled windows before it, and
    the kernel timings after that run saw no kernel at all)."""
    torch.cuda.empty_cache()    # this process's cached blocks, for it
    out = subprocess.run([sys.executable, "-c", SLICE7, ROOT, tmp],
                         capture_output=True, text=True, timeout=1200)
    result = [ln for ln in out.stdout.splitlines()
              if ln.startswith('{"prep": ')]
    for line in out.stdout.splitlines():
        if line.startswith("{") and line not in result:
            print(line, flush=True)
    require(out.returncode == 0 and len(result) == 1,
            f"the slice-7 phases failed: {out.stderr[-4000:]}")
    return json.loads(result[0])


TRACED_RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from cmlpl_tpu_torch.cli import train
from cmlpl_tpu_torch.ops.patch_gather import (gather_patches_bf16,
                                              gather_patches_f32)
(acc_b, acc_e), rep = cs.train_cli_run(
    train.main, sys.argv[2], "prep",
    lambda: (gather_patches_f32.launches, gather_patches_bf16.launches),
    ("net B", "net E"), extra=sys.argv[3:], epochs=2)
print(json.dumps({"accuracy": {"net_b": cs.accuracy(acc_b),
                               "net_e": cs.accuracy(acc_e)}, "report": rep}))
"""


def traced_train_run(tmp, extra):
    """``train_cli_run`` of ``cli.train`` for 2 epochs with ``extra`` in a
    new process; returns (its accuracy, its report)."""
    out = subprocess.run([sys.executable, "-c", TRACED_RUN, ROOT, tmp,
                          *extra], capture_output=True, text=True,
                         timeout=600)
    result = [ln for ln in out.stdout.splitlines()
              if ln.startswith('{"accuracy": ')]
    require(out.returncode == 0 and len(result) == 1,
            f"traced cli.train failed: {out.stderr[-3000:]}")
    last = json.loads(result[0])
    return last["accuracy"], last["report"]


def seed_schedule(labels, seeds: int, steps: int):
    """(S, 1, steps, 128) ids and labels: seed i takes the i-th epoch of
    the default schedule, as the fused run draws them iter-major."""
    li, ly, ui = default_schedule(labels, seeds)
    return tuple(a[:, None, :steps] for a in (li, ly, ui))


def fused_vs_serial_steps(trainer, tscene, seeds: int, steps: int):
    """``steps`` steps of ``seeds`` seeds from ``init_state((SEED, i))``,
    fused and one seed at a time: per seed (fused metrics, serial
    metrics, fused step-1 gradients, serial step-1 gradients, fused
    params, serial params, serial gradient RMS, whether the generators
    end equal, and for a memory-bank trainer whether the banks' counts
    and pointers are equal and their rows' largest difference, else
    None)."""
    li, ly, ui = seed_schedule(tscene.labels, seeds, steps)
    states = [trainer.init_state((SEED, i)) for i in range(seeds)]
    ms = trainer.stack_states(states)
    names = list(ms.params)
    ms, m1 = trainer._run(ms, tscene, li[:, :, :1], ly[:, :, :1],
                          ui[:, :, :1], [1])
    fused_grads = [[ms.params[n].grad[i].cpu().clone() for n in names]
                   for i in range(seeds)]
    ms, m2 = trainer._run(ms, tscene, li[:, :, 1:], ly[:, :, 1:],
                          ui[:, :, 1:], [1], first_batch=1)
    fused = trainer.unstack(ms)
    out = []
    for i in range(seeds):
        st = trainer.init_state((SEED, i))
        st, s1 = trainer.train_epoch(st, tscene, li[i, 0, :1], ly[i, 0, :1],
                                     ui[i, 0, :1], 1)
        named = trainer.named_params(st)
        grads = [named[n].grad.cpu().clone() for n in names]
        st, s2 = trainer.train_epoch(st, tscene, li[i, 0, 1:], ly[i, 0, 1:],
                                     ui[i, 0, 1:], 1)
        opt_of = {id(p): opt for opt in trainer._opts(st)
                  for g in opt.param_groups for p in g["params"]}
        named = trainer.named_params(st)
        moments = [opt_of[id(named[n])].state[named[n]] for n in names]
        rms = [(mo["exp_avg_sq"].cpu() / (1 - 0.999 ** float(mo["step"])))
               .sqrt() for mo in moments]
        fm = {k: torch.cat([m1[k][i, 0], m2[k][i, 0]]).cpu().numpy()
              for k in m1}
        sm = {k: torch.cat([s1[k], s2[k]]).cpu().numpy() for k in s1}
        fp = trainer.named_params(fused[i])
        bank = None
        if getattr(st, "bank", None) is not None:
            bank = (all(torch.equal(getattr(fused[i].bank, f),
                                    getattr(st.bank, f))
                        for f in ("count", "ptr")),
                    float((fused[i].bank.feats - st.bank.feats).abs().max()))
        out.append((fm, sm, fused_grads[i], grads,
                    [fp[n].detach().cpu() for n in names],
                    [named[n].detach().cpu() for n in names], rms,
                    torch.equal(fused[i].generator.get_state(),
                                st.generator.get_state()), bank))
    return out


def fused_window(trainer, tscene, seeds: int) -> dict:
    """The idle share of 20 fused steps of ``seeds`` seeds (after 5), as
    ``profiled_window`` takes it for one seed."""
    li, ly, ui = seed_schedule(tscene.labels, seeds, 45)
    ms = trainer.stack_states([trainer.init_state((SEED, i))
                               for i in range(seeds)])
    trainer._run(ms, tscene, li[:, :, :5], ly[:, :, :5], ui[:, :, :5], [1])
    return profile_window(lambda lo: trainer._run(
        ms, tscene, li[:, :, lo:lo + 20], ly[:, :, lo:lo + 20],
        ui[:, :, lo:lo + 20], [1], first_batch=lo))


def seed_runs(lines):
    """Of a ``cli.train`` output (``--print_per_batches 0``): the indices
    of its training-time lines, and each run's net B and net E OA."""
    train = [i for i, ln in enumerate(lines) if "training time ==" in ln]
    oas = [float(re.search(r"OA=([0-9.]+)", lines[i + 1]).group(1))
           for i, ln in enumerate(lines) if ln.startswith("Result (net")]
    return train, oas[0::2], oas[1::2]


def phase_fused(tmp, tscene, counter_fn, device):
    """``cli.train --num_iters 4 --fused_iters --num_epochs 2`` beside the
    serial ``--num_iters 4`` in this process, the same pair with
    ``--extra_loss memobank``, and one bf16 fused epoch: training time,
    ms a seed-step, each seed's OA and the kernel launches of each; 20
    profiled steps of 4 fused seeds against 20 of one seed (f32 and
    bf16).  Then 3 fused steps of 4 seeds against 3 serial steps of each,
    for CMLPL, CMLPL with the memory bank (the banks' counts and pointers
    equal), CPS and CCT, noise and dropout on, at the card-vs-CPU bounds.
    functorch's per-example fallback (an op with no batching rule) is an
    error throughout.  Returns kernel 1's and kernel 2's training
    launches of the fused runs."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", "There is a performance drop")
        return _phase_fused(tmp, tscene, counter_fn, device)


def _phase_fused(tmp, tscene, counter_fn, device):
    from cmlpl_tpu_torch.cli import train as cli_train
    from cmlpl_tpu_torch.ops.patch_gather import WRAPPERS
    from cmlpl_tpu_torch.train import CCTTrainer, CMLPLTrainer, CPSTrainer
    from cmlpl_tpu_torch.train.state import CMLPLConfig

    seeds, epochs = 4, 2
    runs = {}
    memobank = ["--extra_loss", "memobank"]
    for label, extra in (
            ("serial", []), ("fused", ["--fused_iters"]),
            ("serial_memobank", memobank),
            ("fused_memobank", ["--fused_iters", *memobank]),
            ("fused_bf16", ["--fused_iters", "--compute_dtype", "bfloat16"])):
        ep = 1 if label == "fused_bf16" else epochs
        for wrapper in WRAPPERS:
            wrapper.launches = 0
        _, lines, counts = run_cli(cli_train.main, [
            "--dataID", str(DATA_ID), "--data_root", tmp,
            "--save_path_prefix", os.path.join(tmp, label),
            "--num_epochs", str(ep), "--num_iters", str(seeds),
            "--print_per_batches", "0", *extra], counter_fn)
        train, oa_b, oa_e = seed_runs(lines)
        # the launches of a run's training: from the line before it (the
        # last line of the run before, after its maps)
        launched = [tuple(np.subtract(counts[i], counts[i - 1]
                                      if i else (0, 0))) for i in train]
        train_s = sum(float(re.search(r"== ([0-9.]+)s", lines[i]).group(1))
                      for i in train)
        seed_steps = seeds * ep * 78
        require(len(oa_b) == len(oa_e) == seeds and min(oa_b) > 50,
                f"{label}: OA {oa_b}, {oa_e}")
        runs[label] = {"epochs": ep, "train_s": train_s,
                       "ms_per_seed_step": train_s / seed_steps * 1e3,
                       "oa_net_b": oa_b, "oa_net_e": oa_e,
                       "launches_training": [list(map(int, x))
                                             for x in launched],
                       "launches_with_maps": list(counter_fn())}
    for label in ("serial", "serial_memobank"):
        require(runs[label]["launches_training"] == [[1, 0]] * seeds,
                f"{label} launches {runs[label]['launches_training']}")
    for label in ("fused", "fused_memobank"):
        require(runs[label]["launches_training"] == [[1, 0]],
                f"{label} launches {runs[label]['launches_training']}")
    require(runs["fused_bf16"]["launches_training"] == [[0, 1]],
            f"bf16 fused launches {runs['fused_bf16']['launches_training']}")

    windows = {}
    for dtype in ("float32", "bfloat16"):
        trainer = CMLPLTrainer(CMLPLConfig(compute_dtype=dtype),
                               device=device)
        windows[dtype] = {"fused_4_seeds": fused_window(trainer, tscene,
                                                        seeds),
                          "one_seed": profiled_window(trainer, tscene)}

    # fused vs serial steps, noise and dropout on
    holds = {}
    for algo, cls, extra in (
            ("cmlpl", CMLPLTrainer, {}),
            ("cmlpl_memobank", CMLPLTrainer, {"extra_loss": "memobank"}),
            ("cps", CPSTrainer, {}), ("cct", CCTTrainer, {})):
        trainer = cls(CMLPLConfig(gather_impl="pool", **extra), device=device)
        adams = 2 if algo == "cct" else 1
        worst = {}
        for i, (fm, sm, fg, sg, fp, sp, rms, same_gen, bank) in enumerate(
                fused_vs_serial_steps(trainer, tscene, seeds, 3)):
            what = f"fused {algo} seed {i}"
            require(same_gen, f"{what}: generators differ after the steps")
            require(bank is None or bank[0],
                    f"{what}: the banks' counts or pointers differ")
            grad_err = grad_gap(fg, sg)
            param_err, held = param_gap(
                [(a - b).abs().max() for a, b in zip(fg, sg)], fp, sp, rms,
                rms, adams, trainer.config.lr)
            require_f32_steps(what, fm, sm, grad_err, param_err, held, adams,
                              trainer.config.lr, 3)
            worst[i] = {"loss_max_abs_diff": {
                k: float(np.abs(fm[k] - sm[k]).max()) for k in fm},
                "step1_grad_max_diff_of_tensor_max": grad_err,
                "params": param_err}
            if bank is not None:
                worst[i]["bank_rows_max_abs_diff"] = bank[1]
        holds[algo] = worst
    emit({"phase": "fused", "seeds": seeds, "runs": runs,
          "profiled_windows": windows, "fused_vs_serial_3_steps": holds,
          "note": "ms_per_seed_step: training time over seeds x steps; "
                  "idle share over 20 steps (fused: 20 steps of 4 seeds)"})
    return {"fused_f32": runs["fused"]["launches_training"][0][0],
            "fused_memobank":
            runs["fused_memobank"]["launches_training"][0][0],
            "fused_bf16": runs["fused_bf16"]["launches_training"][0][1],
            "shapes": fused_pool_kernels(tscene, seeds, epochs)}


def fused_pool_kernels(tscene, seeds: int, epochs: int) -> dict:
    """Both kernels at the fused run's pool: the ``seeds`` seeds' pools
    of ``epochs``-epoch default schedules, each padded to the longest, in
    one launch (f32, and bf16 from the bf16 cube), bitwise against the
    plain gather, and timed as ``phase_train_gather`` times the pool."""
    from cmlpl_tpu_torch.data.patches import gather_patches
    from cmlpl_tpu_torch.ops.patch_gather import (gather_patches_bf16,
                                                  gather_patches_f32)
    from cmlpl_tpu_torch.train.driver import seed_pools

    li, _, ui = default_schedule(tscene.labels, seeds * epochs)
    pool, _, _ = seed_pools(*(a.reshape(seeds, epochs, *a.shape[1:])
                              for a in (li, ui)))
    ids = torch.from_numpy(pool).to(tscene.device)
    label = f"fused pool B={len(pool)} ({seeds} seeds)"
    report = {}
    for name, wrapper, dtype in (
            ("patch_gather_f32", gather_patches_f32, torch.float32),
            ("patch_gather_bf16", gather_patches_bf16, torch.bfloat16)):
        cube = tscene.padded_pca.to(dtype)
        got = wrapper(cube, ids, cols=tscene.cols, w=W)
        want = gather_patches(cube, ids, cols=tscene.cols, w=W)
        torch.cuda.synchronize()
        require(torch.equal(bits(got), bits(want)),
                f"{name} {label}: not bitwise equal to the plain gather")
        del got, want
        report[name] = {label: {"max_abs_err": 0.0, "launches_timed": 1,
                                **gather_times(wrapper, cube, [ids],
                                               tscene.cols, rounds=3)}}
        emit({"phase": "fused", "kernel": name, "case": label,
              "bitwise_equal": True, **report[name][label]})
    return report


# --------------------------------------------------------------------------
# slice 8: export (cli.export_model, the native runner aoti_host)
# --------------------------------------------------------------------------

EXPORT_RUNS = (("xla", []), ("dense", ["--eval_gather", "dense"]),
               ("bf16", ["--compute_dtype", "bfloat16"]))
SERVE_REPEAT = 5


def export_cli(argv, counter_fn) -> dict:
    """``cli.export_model`` on ``argv`` with the gather counts reset: its
    printed times, the bundle's MB and the launches its ``--verify`` made."""
    from cmlpl_tpu_torch.cli import export_model
    from cmlpl_tpu_torch.ops.patch_gather import WRAPPERS

    for wrapper in WRAPPERS:
        wrapper.launches = 0
    _, lines, _ = run_cli(export_model.main, argv, counter_fn)
    text = "\n".join(lines)

    def num(pattern):
        found = re.search(pattern, text)
        require(found is not None, f"export_model printed no {pattern!r}: "
                f"{lines}")
        return float(found.group(1))

    require(num(r"agreement vs in-process predictor: ([0-9.]+)") == 1.0,
            f"export_model --verify: {lines}")
    return {"export_s": num(r"compute_dtype=\w+ in ([0-9.]+)s"),
            "aoti_compile_s": num(r"compiled in ([0-9.]+)s"),
            "bundle_mb": num(r"model\.pt2 ([0-9.]+) MB"),
            "verify_artifact_s":
            num(r"artifact inference time == ([0-9.]+)s"),
            "verify_launches": dict(zip(("gather_patches_f32",
                                         "gather_patches_bf16"),
                                        counter_fn()))}


def serve_session(host, bundle, good, bad_cube, spectra, tmp):
    """``aoti_host --serve``: three good requests and one bad (a cube of
    another shape), the bad one third, then a blank line; returns (the
    responses, the labels of each good request)."""
    outs = [os.path.join(tmp, f"serve{i}.npy") for i in range(4)]
    reqs = [f"{good} {spectra} {outs[0]}", f"{good} {spectra} {outs[1]}",
            f"{bad_cube} {spectra} {outs[2]}", f"{good} {spectra} {outs[3]}"]
    proc = subprocess.run([host, "--bundle", bundle, "--serve"],
                          input="\n".join(reqs) + "\n\n", capture_output=True,
                          text=True, timeout=300)
    lines = proc.stdout.splitlines()
    require(proc.returncode == 0 and len(lines) == 4,
            f"aoti_host --serve: rc {proc.returncode}, {lines}, "
            f"{proc.stderr[-2000:]}")
    require([ln.split()[0] for ln in lines] == ["ok", "ok", "error", "ok"],
            f"aoti_host --serve answered {lines}")
    require("shape" in lines[2], f"the bad request's answer: {lines[2]}")
    return lines, [np.load(outs[i]) for i in (0, 1, 3)]


def wait_for(path: str, timeout: float = 1200.0) -> None:
    """Waits until ``path`` exists, the parent process's signal."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        require(time.perf_counter() - t0 < timeout, f"no signal at {path}")
        time.sleep(0.5)


def run_export(tmp, host_build_s, gate) -> dict:
    """The export phase at PaviaU width with the smoke's weights:
    ``cli.export_model --verify --native_dir`` in ``xla`` and ``dense`` (f32)
    and ``xla`` with ``--compute_dtype bfloat16``; each zip artifact's map
    bitwise the in-process ``ScenePredictor``'s of its mode, and the f32
    ``xla`` one bitwise the kernel-1 map (``--verify`` under ``auto``, 406
    launches counted); the runner one-shot on each bundle (``--repeat
    5``), its f32 labels tie-safe to the kernel map (dense: to the dense
    map); a ``--serve`` session.  The exports and their compiles run
    first, beside the parent's phases; the maps, the artifacts' and the
    runner's timings once the file ``gate`` exists (the parent has left
    the card).  Returns the phase's kernel-1 launches."""
    from cmlpl_tpu_torch.cli._common import logits_fn
    from cmlpl_tpu_torch.data.io import synthetic_scene
    from cmlpl_tpu_torch.data.prep import prepare_scene
    from cmlpl_tpu_torch.eval.inference import (ScenePredictor,
                                                dense_scene_logits)
    from cmlpl_tpu_torch.models.basenet import BaseNet2
    from cmlpl_tpu_torch.native.aoti_launcher import build_host, run_host
    from cmlpl_tpu_torch.ops.patch_gather import (gather_patches_bf16,
                                                  gather_patches_f32)
    from cmlpl_tpu_torch.registry import get_dataset
    from cmlpl_tpu_torch.utils.export import load_exported
    from cmlpl_tpu_torch.weights import (init_basenet2_params,
                                         save_params_npz,
                                         state_dict_from_jax)

    def counter_fn():
        return (gather_patches_f32.launches, gather_patches_bf16.launches)

    os.makedirs(tmp, exist_ok=True)
    device = torch.device("cuda")
    spec = get_dataset(DATA_ID)
    params = init_basenet2_params(SEED, n_pc=N_PC,
                                  num_features=spec.num_bands,
                                  num_classes=spec.num_classes,
                                  patch_size=W)
    weights = os.path.join(tmp, "w.npz")
    save_params_npz(weights, params)
    cube, gt = synthetic_scene(DATA_ID)
    scene = prepare_scene(DATA_ID, cube=cube, gt=gt, patch_size=W,
                          n_pc=N_PC, device=device)
    tiles = -(-scene.num_pixels // TILE)
    models = {}
    for dtype in ("float32", "bfloat16"):
        model = BaseNet2(num_features=spec.num_bands,
                         num_classes=spec.num_classes, n_pc=N_PC,
                         patch_size=W, compute_dtype=dtype)
        model.load_state_dict(state_dict_from_jax(params))
        models[dtype] = model.to(device).eval()
    apply = logits_fn(models["float32"])
    common = ["--dataID", str(DATA_ID), "--n_PC", str(N_PC), "--w", str(W),
              "--val_batch_size", str(TILE), "--weights", weights,
              "--data_root", tmp]
    cube_npy = os.path.join(tmp, "cube.npy")
    spectra_npy = os.path.join(tmp, "spectra.npy")
    np.save(cube_npy, scene.padded_pca.cpu().numpy())
    np.save(spectra_npy, scene.spectra.cpu().numpy())
    bad_npy = os.path.join(tmp, "bad_cube.npy")
    np.save(bad_npy, scene.padded_pca[:100].cpu().numpy())

    host = build_host()
    # the exports and their compiles (host work), beside the parent's
    # phases; --verify maps once each on the card
    clis = {}
    launches = 0    # kernel 1 on the phase's path: each --verify's map
    for name, extra in EXPORT_RUNS:
        cli = export_cli(common + extra + [
            "--out", os.path.join(tmp, f"{name}.cmlpl.zip"), "--verify",
            "--native_dir", os.path.join(tmp, f"bundle_{name}")], counter_fn)
        expect = (0, 0) if name == "dense" else (tiles, 0)
        require(tuple(cli["verify_launches"].values()) == expect,
                f"export {name}: --verify launched {cli['verify_launches']}")
        launches += cli["verify_launches"]["gather_patches_f32"]
        clis[name] = cli
    wait_for(gate)

    # the in-process maps the artifacts are held to
    for wrapper in (gather_patches_f32, gather_patches_bf16):
        wrapper.launches = 0
    kernel_map = ScenePredictor(apply, patch_size=W, cols=scene.cols,
                                tile=TILE, gather="pallas")
    want = {"xla": kernel_map(scene)}
    require(counter_fn() == (tiles, 0), f"kernel map launches {counter_fn()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kernel_map(scene)
    kernel_map_s = time.perf_counter() - t0
    want["dense"] = ScenePredictor(
        None, params=models["float32"].state_dict(), patch_size=W,
        cols=scene.cols, gather="dense")(scene)
    want["bf16"] = ScenePredictor(
        logits_fn(models["bfloat16"]), patch_size=W, cols=scene.cols,
        tile=TILE, gather="xla")(scene)
    with torch.inference_mode():
        dense_logits = dense_scene_logits(models["float32"].state_dict(),
                                          scene).cpu()
    logits_at = {"xla": tiled_logits(apply, scene),
                 "dense": lambda ids: dense_logits[torch.from_numpy(ids)],
                 "bf16": tiled_logits(logits_fn(models["bfloat16"]), scene)}

    report = {"torch_version": torch.__version__,
              "runner_build_s": float(host_build_s), "tiles": tiles,
              "pallas_map_s": kernel_map_s, "runs": {}}
    for name, _ in EXPORT_RUNS:
        out = os.path.join(tmp, f"{name}.cmlpl.zip")
        bundle = os.path.join(tmp, f"bundle_{name}")
        cli = clis[name]
        meta, fn = load_exported(out)
        fn(scene.padded_pca, scene.spectra)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(scene.padded_pca, scene.spectra)
        artifact_s = time.perf_counter() - t0
        require(got.shape == (scene.num_pixels,) and got.dtype == np.int32,
                f"export {name}: artifact map {got.shape} {got.dtype}")
        require(np.array_equal(got, want[name]),
                f"export {name}: the artifact's map != ScenePredictor's: "
                f"{int((got != want[name]).sum())} pixels")
        labels_npy = os.path.join(tmp, f"labels_{name}.npy")
        native = run_host(bundle, cube_npy, spectra_npy, labels_npy,
                          repeat=SERVE_REPEAT, timeout=600)
        labels = np.load(labels_npy)
        # bf16 too: its package is compiled with Inductor's
        # precision-cast emulation, so it rounds where eager rounds
        tie_safe_equal(labels, want[name], logits_at[name],
                       f"aoti_host {name} vs the in-process map")
        run = {"meta": {k: meta[k] for k in ("gather", "tile", "platforms",
                                             "compute_dtype",
                                             "torch_version")},
               **cli, "artifact_map_s": artifact_s,
               "artifact_equals_in_process_map": True, "runner": native,
               "runner_differing_pixels":
               int((labels != want[name]).sum())}
        if name == "xla":
            lines, served = serve_session(host, bundle, cube_npy, bad_npy,
                                          spectra_npy, tmp)
            require(all(np.array_equal(m, labels) for m in served),
                    "aoti_host --serve labels != the one-shot labels")
            run["serve"] = {"responses": lines, "ms_per_request":
                            [float(ln.split()[-1]) for ln in lines
                             if ln.startswith("ok ")]}
        report["runs"][name] = run
    emit({"phase": "export", "card": card_name_and_power(), **report,
          "note": "random weights on the synthetic PaviaU-size scene; the "
                  "bf16 bundle compiled with Inductor's precision-cast "
                  "emulation"})
    return {"launches": launches}


# --------------------------------------------------------------------------
# slice 9: the training-run bundle
# --------------------------------------------------------------------------

BUNDLE_STEPS = TRAIN_EPOCHS * 78
# the memory-bank bundle: the default run with the bank, its depth cut to
# 2 epochs (156 steps) for the smoke's time, its width not
MEMOBANK_BUNDLE = ("--extra_loss", "memobank", "--num_epochs", "2")
MEMOBANK_BUNDLE_STEPS = 2 * 78
# the bundle's map may lose at most this many OA points to the eager run's
# (the same initial state and schedule, other random streams: the two
# runs are equal in distribution only)
BUNDLE_OA_SLACK = 0.01


class FirstBatch:
    """A sampler whose every epoch is the first batch of ``sampler``'s."""

    def __init__(self, sampler):
        self.batch = next(iter(sampler.epoch()))

    def epoch(self):
        yield self.batch


def adam_moment(lf, side: dict, kind: str):
    """The Adam moment ``kind`` ("mu" or "nu") of the param leaf ``lf`` in
    a run's outputs ``side`` (flax layout, by bundle name), and its
    count."""
    net = lf.name.split(".")[1]
    rest = lf.name.split(".params.", 1)[1]
    count = float(side[f"state.{net}.opt_state.0.count"])
    return side[f"state.{net}.opt_state.0.{kind}.{rest}"], count


def moment_grad(lf, side: dict):
    """The bias-corrected first moment of ``lf``: after one step, its
    gradient."""
    mu, count = adam_moment(lf, side, "mu")
    return mu / (1 - 0.9 ** count)


def moment_rms(lf, side: dict):
    """The bias-corrected gradient RMS of ``lf``."""
    nu, count = adam_moment(lf, side, "nu")
    return (nu / (1 - 0.999 ** count)).sqrt()


def bundle_vs_eager_epoch(tscene) -> dict:
    """(a) One epoch of CMLPL with noise and dropout off, from one state:
    the exported run program, run by ``.module()`` on the card (no
    AOTInductor compile), against the eager ``CMLPLTrainer`` on the card,
    under the card's f32 step bounds (``require_f32_steps``,
    ``param_gap``) over the 78 steps.  The program returns no gradients,
    so the step-1 gradients are the bias-corrected first moments (Adam's
    running mean of the gradients; after one step, the gradient) of a
    one-step program of the same builder on the epoch's first batch,
    against the eager trainer's one step; each weight's gradient RMS
    comes from its second moment after the 78 steps.  The first moments
    after 78 steps are reported, not held: cuDNN's weight-gradient sums
    change order from run to run, so two eager runs from one state part
    there by as much as the step-1 bound: a second eager run reports that
    floor beside the program's gap."""
    from cmlpl_tpu_torch.data.pipeline import SemiSupervisedSampler
    from cmlpl_tpu_torch.data.splits import generate_splits
    from cmlpl_tpu_torch.device import compute_precision
    from cmlpl_tpu_torch.train.cmlpl import CMLPLTrainer
    from cmlpl_tpu_torch.train.functional import StateLayout
    from cmlpl_tpu_torch.train.state import CMLPLConfig
    from cmlpl_tpu_torch.utils.export import build_run_exported

    device = torch.device("cuda")
    cfg = CMLPLConfig(noise=0.0, dropout=0.0, num_epochs=1,
                      gather_impl="pool")
    trainer = CMLPLTrainer(cfg, device=device)
    labels = tscene.labels
    splits = generate_splits(labels, num_label=5)

    def sampler():
        return SemiSupervisedSampler(splits, labels, 128, 128, 10000,
                                     seed=1088)

    def program_run(smp):
        t0 = time.perf_counter()
        meta, exported, inputs = build_run_exported(trainer, tscene, smp,
                                                    (SEED, 0))
        export_s = time.perf_counter() - t0
        args = [torch.from_numpy(np.array(v)).to(device)
                for v in inputs.values()]
        program = exported.module()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with compute_precision(meta["compute_dtype"]):
            outs = program(*args)
        torch.cuda.synchronize()
        return ({n: o.cpu() for n, o in zip(meta["output_names"], outs)},
                export_s, time.perf_counter() - t0)

    def eager_run(smp):
        state = trainer.init_state((SEED, 0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.train_run(state, tscene, smp)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        layout = StateLayout(trainer, state, np.zeros(2, np.uint32))
        return (layout.leaves,
                {lf.name: torch.from_numpy(np.asarray(v))
                 for lf, v in zip(layout.leaves, layout.values)},
                metrics, run_s)

    got, export_s, module_s = program_run(sampler())
    leaves, want, metrics, eager_s = eager_run(sampler())
    _, again, _, _ = eager_run(sampler())
    got1, export1_s, _ = program_run(FirstBatch(sampler()))
    _, want1, _, _ = eager_run(FirstBatch(sampler()))
    mc = {k[len("metrics."):]: v.numpy().reshape(-1)
          for k, v in got.items() if k.startswith("metrics.")}
    mh = {k: v.cpu().numpy().reshape(-1) for k, v in metrics.items()}
    require(sorted(mc) == sorted(mh), f"metrics {sorted(mc)} vs {sorted(mh)}")
    for k in mc:
        require(np.all(np.isfinite(mc[k])), f"bundle metric {k} not finite")

    params = [lf for lf in leaves if lf.kind == "param"]

    require(all(float(s[f"state.{n}.opt_state.0.count"]) == 1
                for s in (got1, want1) for n in ("net_b", "net_e")),
            "the one-step runs took another number of steps")
    gc = [moment_grad(lf, got1) for lf in params]
    gh = [moment_grad(lf, want1) for lf in params]
    grad_err = grad_gap(gc, gh)
    pc = [got[lf.name] for lf in params]
    ph = [want[lf.name] for lf in params]
    param_err, held = param_gap(
        [(a - b).abs().max() for a, b in zip(gc, gh)], pc, ph,
        [moment_rms(lf, want) for lf in params],
        [moment_rms(lf, got) for lf in params],
        1, cfg.lr)
    loss_err = {k: float(np.abs(mc[k] - mh[k]).max()) for k in mc}
    report = {"phase": "train_bundle_vs_eager", "steps": 78,
              "noise": 0.0, "dropout": 0.0, "export_s": export_s,
              "one_step_export_s": export1_s,
              "module_run_s": module_s, "eager_run_s": eager_s,
              "max_abs_diff": loss_err,
              "step1_grad_max_diff_of_tensor_max": grad_err,
              "step1_grads_bitwise": all(torch.equal(a, b)
                                         for a, b in zip(gc, gh)),
              "first_moment_max_diff_of_tensor_max": grad_gap(
                  [moment_grad(lf, got) for lf in params],
                  [moment_grad(lf, want) for lf in params]),
              "eager_vs_eager_first_moment_max_diff_of_tensor_max":
              grad_gap([moment_grad(lf, again) for lf in params],
                       [moment_grad(lf, want) for lf in params]),
              "eager_vs_eager_params_max_abs_diff": max(
                  float((again[lf.name] - want[lf.name]).abs().max())
                  for lf in params),
              "params_max_abs_diff": param_err,
              "bitwise_params": all(torch.equal(a, b)
                                    for a, b in zip(pc, ph))}
    emit(report)
    require_f32_steps("train bundle .module() vs eager, 78 steps", mc, mh,
                      grad_err, param_err, held, 1, cfg.lr, 78)
    return report


def threefry_card_vs_cpu() -> dict:
    """(d) The counter stream's block on the card equals the CPU's, bit
    for bit, for a fixed key over 2**20 counter pairs."""
    from cmlpl_tpu_torch.core.rng import threefry2x32

    x = torch.arange(1 << 20, dtype=torch.int64)
    key = (0x12345678, 0x9ABCDEF0)
    cpu = threefry2x32(*(torch.tensor(k) for k in key), x,
                       (x * 2654435761) & 0xFFFFFFFF)
    xc = x.cuda()
    card = threefry2x32(*(torch.tensor(k, device="cuda") for k in key), xc,
                        (xc * 2654435761) & 0xFFFFFFFF)
    equal = all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card))
    report = {"phase": "train_bundle_threefry", "counters": 1 << 20,
              "card_equals_cpu": equal}
    emit(report)
    require(equal, "threefry2x32 on the card != on the CPU")
    return report


def one_step_program_vs_eager(tscene, trainer) -> dict:
    """A one-step run program of ``trainer`` (``.module()``, on the card)
    on the default schedule's first batch, against the eager trainer's
    step from the same initial state whose draws come from the program's
    first ``CounterStream`` and whose patches its gather takes (the
    trainer's per-step gather, or the plain gather of the pool's rows).
    Returns the program's outputs and the eager state's, by name (flax
    layout), the eager step's metrics, the meta, the export's seconds, the
    step-1 gradients' gap (the bias-corrected first moments, each tensor's
    largest difference over its largest entry), and the kernel wrappers'
    launches in the program's run (the operators launch through them)."""
    from cmlpl_tpu_torch.core.rng import CounterStream
    from cmlpl_tpu_torch.data.patches import gather_patches
    from cmlpl_tpu_torch.data.pipeline import SemiSupervisedSampler
    from cmlpl_tpu_torch.data.splits import generate_splits
    from cmlpl_tpu_torch.device import compute_precision
    from cmlpl_tpu_torch.ops.patch_gather import WRAPPERS
    from cmlpl_tpu_torch.train.driver import Apply
    from cmlpl_tpu_torch.train.functional import StateLayout
    from cmlpl_tpu_torch.utils.export import build_run_exported

    device = torch.device("cuda")
    labels = tscene.labels
    sampler = FirstBatch(SemiSupervisedSampler(
        generate_splits(labels, num_label=5), labels, 128, 128, 10000,
        seed=1088))
    t0 = time.perf_counter()
    meta, exported, inputs = build_run_exported(trainer, tscene, sampler,
                                                (SEED, 0))
    export_s = time.perf_counter() - t0
    args = [torch.from_numpy(np.array(v)).to(device)
            for v in inputs.values()]
    for wrapper in WRAPPERS:
        wrapper.launches = 0
    with compute_precision(meta["compute_dtype"]):
        outs = exported.module()(*args)
    launches = {w.__name__: w.launches for w in WRAPPERS}
    got = {n: o.cpu() for n, o in zip(meta["output_names"], outs)}

    state = trainer.init_state((SEED, 0))
    li, ly, ui = (torch.from_numpy(np.asarray(a)).to(device)
                  for a in sampler.batch)
    if trainer.config.gather_impl == "pool":
        xp_l, xp_u = (trainer.cast(gather_patches(
            tscene.padded_pca, i.int(), cols=tscene.cols, w=W))
            for i in (li, ui))
    else:
        cube = trainer._prep_cube(tscene.padded_pca)
        xp_l, xp_u = (trainer.cast(trainer._gather(
            cube, i.int().contiguous(), tscene.cols, W)) for i in (li, ui))
    x_l, x_u = (trainer.cast(tscene.spectra).index_select(0, i.long())
                for i in (li, ui))
    key = args[meta["input_names"].index("state.rng")]
    thr = args[meta["input_names"].index("extra0")][0]
    with compute_precision("float32"):
        d = trainer._draws(CounterStream(key, 0), xp_l, x_l, xp_u, x_u,
                           ly.long())
        carry = trainer._carry(state)
        loss, metrics, writes = trainer._losses(
            Apply(torch.nn.ModuleDict(trainer._modules(state))), d,
            ly.long(), carry, 0, 0, thr)
        trainer._update(state, loss, *trainer._opts(state))
        trainer._write(carry, writes)
    layout = StateLayout(trainer, state, np.zeros(2, np.uint32))
    want = {lf.name: torch.from_numpy(np.asarray(v))
            for lf, v in zip(layout.leaves, layout.values)}
    params = [lf for lf in layout.leaves if lf.kind == "param"]
    grad_err = grad_gap([moment_grad(lf, got) for lf in params],
                        [moment_grad(lf, want) for lf in params])
    return {"got": got, "want": want, "metrics": metrics, "meta": meta,
            "export_s": export_s, "grad_err": grad_err,
            "program_launches": launches}


def bundle_memobank_step_vs_eager(tscene) -> dict:
    """(e) The memory-bank run program's first step against one eager
    step on the same draws, on the card, noise and dropout on
    (:func:`one_step_program_vs_eager`): the default config with
    ``extra_loss="memobank"``, net E sharpened (its classifier times 30,
    so that the bank has anchors and its term a gradient).  The step-1
    gradients within ``CARD_CPU_GRAD_TOL`` of each tensor's largest, as
    :func:`bundle_vs_eager_epoch` holds them; the banks' counts and
    pointers equal."""
    from cmlpl_tpu_torch.train.cmlpl import CMLPLTrainer
    from cmlpl_tpu_torch.train.state import CMLPLConfig

    trainer = CMLPLTrainer(CMLPLConfig(num_epochs=1, gather_impl="pool",
                                       extra_loss="memobank"),
                           device=torch.device("cuda"))
    init_state = trainer.init_state

    def sharpened(seed):
        state = init_state(seed)
        with torch.no_grad():
            for p in state.net_e.model.classifier.parameters():
                p.mul_(30)
        return state

    trainer.init_state = sharpened
    step = one_step_program_vs_eager(tscene, trainer)
    got, want, metrics = step["got"], step["want"], step["metrics"]
    grad_err = step["grad_err"]
    bank_equal = all(torch.equal(got[f"state.bank.{f}"],
                                 want[f"state.bank.{f}"])
                     for f in ("count", "ptr"))
    extra = (float(got["metrics.extra_loss"].reshape(-1)[0]),
             float(metrics["extra_loss"]))
    report = {"phase": "train_bundle_memobank_vs_eager", "steps": 1,
              "export_s": step["export_s"],
              "step1_grad_max_diff_of_tensor_max": grad_err,
              "bank_count_ptr_equal": bank_equal,
              "bank_count": got["state.bank.count"].tolist(),
              "bank_rows_max_abs_diff": float(
                  (got["state.bank.feats"]
                   - want["state.bank.feats"]).abs().max()),
              "extra_loss_program_eager": extra,
              "loss_max_abs_diff": {
                  k: abs(float(got[f"metrics.{k}"].reshape(-1)[0])
                         - float(v)) for k, v in metrics.items()}}
    emit(report)
    require(grad_err <= CARD_CPU_GRAD_TOL,
            f"memobank program vs eager step: step-1 gradients {grad_err}")
    require(bank_equal, "memobank program vs eager step: the banks' counts "
            "or pointers differ")
    require(extra[1] > 0 and int(got["state.bank.count"].sum()) > 0,
            f"the bank took no part in the step: {report}")
    return report


# --------------------------------------------------------------------------
# slice 11: the per-step training bundle (the gather kernels inside the
# run program, as their cmlpl operators)
# --------------------------------------------------------------------------

# the default f32 CMLPL run with kernel 1 twice a step inside the program
# (--gather_impl pallas), its depth cut to 2 epochs (156 steps) for the
# smoke's time, its width not
PER_STEP_BUNDLE = ("--gather_impl", "pallas", "--num_epochs", "2")
PER_STEP_BUNDLE_STEPS = 2 * 78
#: each per-step mode's operator in its run program
PER_STEP_OPS = {"xla": [], "pallas": ["cmlpl::gather_patches_f32"],
                "pallas_bf16": ["cmlpl::gather_patches_bf16"]}


def per_step_steps_vs_eager(tscene) -> dict:
    """(a) Each per-step mode's one-step program (``.module()``, no
    AOTInductor compile) of the default f32 config, noise and dropout on,
    against the eager step of its mode on the same counter-stream draws
    (:func:`one_step_program_vs_eager`): "pallas" and "pallas_bf16" gather
    by their kernel's operator inside the program, "xla" by the plain
    gather; the step-1 gradients within ``CARD_CPU_GRAD_TOL`` of each
    tensor's largest (a "pallas_bf16" step is an f32 step on
    bf16-quantised patches, the same in both), the losses at the card's
    f32 loss bounds."""
    from cmlpl_tpu_torch.train.cmlpl import CMLPLTrainer
    from cmlpl_tpu_torch.train.state import CMLPLConfig

    report = {}
    for mode, ops in PER_STEP_OPS.items():
        trainer = CMLPLTrainer(CMLPLConfig(num_epochs=1, gather_impl=mode),
                               device=torch.device("cuda"))
        step = one_step_program_vs_eager(tscene, trainer)
        got, metrics = step["got"], step["metrics"]
        losses = {k: (float(got[f"metrics.{k}"].reshape(-1)[0]), float(v))
                  for k, v in metrics.items()}
        report[mode] = {"export_s": step["export_s"],
                        "custom_ops": step["meta"]["custom_ops"],
                        "program_launches": step["program_launches"],
                        "step1_grad_max_diff_of_tensor_max":
                        step["grad_err"], "losses_program_eager": losses}
        emit({"phase": "train_bundle_per_step_vs_eager", "gather_impl": mode,
              "steps": 1, **report[mode]})
        require(step["meta"]["gather_impl"] == mode
                and step["meta"]["custom_ops"] == ops,
                f"{mode} program: meta {step['meta']}")
        # a kernel mode's step launches its kernel twice, the plain
        # gather's none
        want = {"gather_patches_f32": 2 * (mode == "pallas"),
                "gather_patches_bf16": 2 * (mode == "pallas_bf16")}
        require(step["program_launches"] == want,
                f"{mode} program: kernel launches {step['program_launches']}"
                " in one step")
        require(step["grad_err"] <= CARD_CPU_GRAD_TOL,
                f"{mode} program vs eager step: step-1 gradients "
                f"{step['grad_err']}")
        for k, (a, b) in losses.items():
            if k in ("acc", "mask_rate"):
                continue       # argmax and threshold decisions
            require(np.isclose(a, b, rtol=CARD_CPU_LOSS_RTOL,
                               atol=CARD_CPU_LOSS_ATOL),
                    f"{mode} program vs eager step {k}: {a} vs {b}")
    return report


def run_per_step_bundle_child(tmp) -> dict:
    """(b) ``cli.export_model --train_bundle --gather_impl pallas`` of the
    default f32 CMLPL run, 2 epochs, at PaviaU width, exported and
    compiled by AOTInductor; then its package run in this process (no
    other trace here) by ``aoti_load_package``: once to warm up, once
    under the profiler, which must see kernel 1 launched on the card 2 a
    step, as the operator's wrapper counts it.  Returns the bundle's path,
    the export's numbers, the launches, kernel 1's device µs a launch
    inside the program, the Python run's wall ms (the card shared with the
    smoke's other phases) and its outputs' step-0 metrics."""
    import torch._inductor

    from cmlpl_tpu_torch.device import compute_precision
    from cmlpl_tpu_torch.ops.patch_gather import WRAPPERS, gather_patches_f32

    built = export_train_bundle(tmp, "bundle_per_step", PER_STEP_BUNDLE)
    bundle = built["bundle"]
    with open(os.path.join(bundle, "meta.json")) as f:
        meta = json.load(f)
    require(meta["gather_impl"] == "pallas"
            and meta["custom_ops"] == PER_STEP_OPS["pallas"]
            and "pool_idx" not in meta["input_names"]
            and meta["num_epochs"] * meta["batches_per_epoch"]
            == PER_STEP_BUNDLE_STEPS, f"per-step bundle meta {meta}")
    package = torch._inductor.aoti_load_package(
        os.path.join(bundle, "model.pt2"))
    args = [torch.from_numpy(np.load(os.path.join(
        bundle, "inputs", n + ".npy"))).cuda() for n in meta["input_names"]]
    outs = []
    with compute_precision(meta["compute_dtype"]):
        package(*args)
        for wrapper in WRAPPERS:
            wrapper.launches = 0
        dev_ms, counts, wall_ms = profiled(
            lambda: outs.append(package(*args)), [()])
    launched = {"gather_patches_f32": gather_patches_f32.launches,
                "gather_patches_bf16": WRAPPERS[1].launches}
    keys = [k for k in counts if KERNEL_NEEDLE in k]
    device_launches = sum(counts[k] for k in keys)
    step0 = {n: float(o.reshape(-1)[0]) for n, o in
             zip(meta["output_names"], outs[0]) if n.startswith("metrics.")}
    report = {"phase": "train_bundle_per_step_python",
              "steps": PER_STEP_BUNDLE_STEPS,
              "kernel_device_launches": device_launches,
              "kernel_names": keys,
              "kernel_device_us_per_launch":
              sum(dev_ms[k] for k in keys) / max(device_launches, 1) * 1e3,
              "wrapper_launches": launched, "python_package_run_ms": wall_ms,
              "note": "the compiled package in Python, under the profiler "
                      "(card activity), beside the smoke's other phases"}
    emit(report)
    want = 2 * PER_STEP_BUNDLE_STEPS
    require(device_launches == want,
            f"kernel 1 launched {device_launches} times on the card inside "
            f"the per-step program, not {want}: {keys}")
    require(launched == {"gather_patches_f32": want,
                         "gather_patches_bf16": 0},
            f"the per-step program's wrapper launches {launched}")
    return {"bundle": bundle, "export": built["export"], **report,
            "step0": step0}


def export_train_bundle(tmp, name: str, extra=()) -> dict:
    """``cli.export_model --train_bundle <tmp>/<name>`` at PaviaU width
    with the training flags ``extra``; returns its path and its numbers
    (export and AOTInductor compile s, MB)."""
    from cmlpl_tpu_torch.cli import export_model

    bundle = os.path.join(tmp, name)
    t0 = time.perf_counter()
    _, lines, _ = run_cli(export_model.main, [
        "--dataID", str(DATA_ID), "--data_root", tmp, *extra,
        "--train_bundle", bundle], lambda: (0, 0))
    wall_s = time.perf_counter() - t0
    text = "\n".join(lines)
    found = re.search(
        r"([0-9.]+) MB AOTInductor package, (\d+) inputs \(([0-9.]+) MB\), "
        r"(\d+) outputs, platforms=\['cuda'\] export_s=([0-9.]+) "
        r"aoti_compile_s=([0-9.]+)", text)
    require(found is not None, f"export_model --train_bundle: {lines}")
    export = {"flags": list(extra), "bundle_mb": float(found.group(1)),
              "inputs": int(found.group(2)),
              "inputs_mb": float(found.group(3)),
              "outputs": int(found.group(4)),
              "export_s": float(found.group(5)),
              "aoti_compile_s": float(found.group(6)), "cli_wall_s": wall_s}
    for part in ("model.pt2", "signature.txt", "meta.json", "inputs"):
        require(os.path.exists(os.path.join(bundle, part)),
                f"the bundle {name} has no {part}")
    emit({"phase": "train_bundle_export", "bundle": name, **export})
    return {"bundle": bundle, "export": export}


def run_train_bundle_child(tmp) -> dict:
    """The training bundles' builds (b): ``cli.export_model
    --train_bundle`` of the default 20-epoch f32 CMLPL run at PaviaU width
    and then of its 2-epoch memory-bank run (``--extra_loss memobank``),
    each exported and compiled by AOTInductor.  Returns the bundles'
    paths and the exports' numbers."""
    default = export_train_bundle(tmp, "bundle")
    memobank = export_train_bundle(tmp, "bundle_memobank", MEMOBANK_BUNDLE)
    return {"bundle": default["bundle"], "export": default["export"],
            "memobank": memobank}


def run_bundle_checks_child() -> dict:
    """The run program's checks that need no compiled bundle: (a)
    :func:`bundle_vs_eager_epoch`, (d) :func:`threefry_card_vs_cpu`, (e)
    :func:`bundle_memobank_step_vs_eager` and the per-step modes' one-step
    programs (:func:`per_step_steps_vs_eager`).  Returns what the
    ``train_bundle`` phases report of them."""
    from cmlpl_tpu_torch.data.io import synthetic_scene
    from cmlpl_tpu_torch.data.prep import prepare_scene

    cube, gt = synthetic_scene(DATA_ID)
    tscene = prepare_scene(DATA_ID, cube=cube, gt=gt, patch_size=W,
                           n_pc=N_PC, device=torch.device("cuda"))
    epoch = bundle_vs_eager_epoch(tscene)
    bits = threefry_card_vs_cpu()
    step = bundle_memobank_step_vs_eager(tscene)
    per_step = per_step_steps_vs_eager(tscene)
    return {"per_step": per_step,
            "vs_eager_bitwise_params": epoch["bitwise_params"],
            "threefry_card_equals_cpu": bits["card_equals_cpu"],
            "memobank_step1_grad_max_diff_of_tensor_max":
            step["step1_grad_max_diff_of_tensor_max"],
            "per_step_step1_grad_max_diff_of_tensor_max": {
                mode: r["step1_grad_max_diff_of_tensor_max"]
                for mode, r in per_step.items()}}


CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
print(json.dumps({"child": getattr(cs, sys.argv[2])(*sys.argv[3:])}),
      flush=True)
"""


def start_child(tmp, fn: str, *args, nice: int = 10, env=None):
    """``chip_smoke.<fn>(*args)`` (string arguments) started in a new
    process, by default at a lower priority and with 4 compile workers, so
    its exports and AOTInductor compiles (minutes) run beside the phases
    of this one and leave them most of the host; its output goes to files
    in ``tmp``; ``env`` adds to its environment.  Returns (the process,
    ``tmp``, ``fn``)."""
    os.makedirs(tmp, exist_ok=True)
    out = open(os.path.join(tmp, "child.out"), "w")
    err = open(os.path.join(tmp, "child.err"), "w")
    env = dict(os.environ, **(env or {}))
    if nice:
        env["TORCHINDUCTOR_COMPILE_THREADS"] = "4"
    proc = subprocess.Popen(["nice", "-n", str(nice), sys.executable, "-c",
                             CHILD, ROOT, fn, *map(str, args)],
                            stdout=out, stderr=err, env=env, text=True)
    out.close()
    err.close()
    return proc, tmp, fn


def finish_child(child, timeout: float = 900) -> dict:
    """Waits for a :func:`start_child` process (at most ``timeout`` s
    more), prints its phase lines and returns its result."""
    proc, tmp, fn = child
    rc = proc.wait(timeout=timeout)
    with open(os.path.join(tmp, "child.out")) as f:
        lines = f.read().splitlines()
    result = [ln for ln in lines if ln.startswith('{"child": ')]
    for line in lines:
        if line.startswith("{") and line not in result:
            print(line, flush=True)
    with open(os.path.join(tmp, "child.err")) as f:
        err = f.read()
    require(rc == 0 and len(result) == 1,
            f"the {fn} child failed (rc {rc}): {lines[-5:]}\n"
            f"{err[-4000:]}")
    return json.loads(result[0])["child"]


def phase_train_bundle(child: dict, tmp, eager: dict, eager_memobank: dict,
                       counter_fn) -> dict:
    """(b) The 20-epoch bundle run by the C++ runner (``--inputs
    --outdir``, twice) and by ``torch._inductor.aoti_load_package`` in
    Python; (c) ``--import_run`` of the runner's outputs and ``predict
    --checkpoint_dir --net b`` of the checkpoint, whose OA may be at most
    ``BUNDLE_OA_SLACK`` below the eager ``cli.train`` run's (``eager``:
    its OA and ``ms_per_step``).  The two runs of one package are held
    bitwise or, where cuDNN's run-to-run rounding parts them (its weight-
    gradient sums change order; Adam carries it through 1,560 steps),
    step 0's metrics within the card-vs-CPU loss bounds and the Python
    run's map at the same OA bound.  Then (f) the 2-epoch memory-bank
    bundle by the runner (twice), beside the eager memory-bank epoch's
    ``ms_per_step`` (``eager_memobank``), imported and mapped: finite
    outputs, the bank filled, OA net B over 50.  Returns the maps' kernel-1
    launches."""
    import torch._inductor

    from cmlpl_tpu_torch.cli import export_model
    from cmlpl_tpu_torch.data.io import synthetic_scene
    from cmlpl_tpu_torch.data.prep import prepare_scene
    from cmlpl_tpu_torch.data.splits import generate_splits
    from cmlpl_tpu_torch.device import compute_precision
    from cmlpl_tpu_torch.eval.metrics import cal_accuracy
    from cmlpl_tpu_torch.native.aoti_launcher import run_host_io

    bundle = child["bundle"]
    with open(os.path.join(bundle, "meta.json")) as f:
        meta = json.load(f)
    require(meta["kind"] == "train_run" and meta["num_epochs"]
            * meta["batches_per_epoch"] == BUNDLE_STEPS, f"meta {meta}")
    out_runner = os.path.join(tmp, "runner_out")
    runner = run_host_io(bundle, os.path.join(bundle, "inputs"), out_runner,
                         repeat=2, timeout=900)
    require(runner["num_inputs"] == len(meta["input_names"])
            and runner["num_outputs"] == len(meta["output_names"]),
            f"runner {runner}")

    package = torch._inductor.aoti_load_package(
        os.path.join(bundle, "model.pt2"))
    args = [torch.from_numpy(np.load(os.path.join(
        bundle, "inputs", n + ".npy"))).cuda() for n in meta["input_names"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with compute_precision(meta["compute_dtype"]):
        outs = package(*args)
    py = {n: o.cpu().numpy() for n, o in zip(meta["output_names"], outs)}
    python_ms = (time.perf_counter() - t0) * 1e3
    del package, args, outs
    cpp = {n: np.load(os.path.join(out_runner, n + ".npy"))
           for n in meta["output_names"]}
    for n in meta["output_names"]:
        require(np.all(np.isfinite(cpp[n])), f"runner output {n} not finite")
    differ = [n for n in meta["output_names"]
              if not np.array_equal(cpp[n], py[n])]
    metric_names = [n for n in meta["output_names"]
                    if n.startswith("metrics.")]
    # where the two runs part: a step of one program from one state agrees
    # to rounding; the steps after it carry cuDNN's run-to-run rounding
    # (its weight-gradient sums change order) through 1,560 Adam steps
    first_diff = {}
    for n in metric_names:
        at = np.flatnonzero((cpp[n] != py[n]).reshape(-1))
        first_diff[n] = int(at[0]) if at.size else None
    step0 = {n: (float(cpp[n].reshape(-1)[0]), float(py[n].reshape(-1)[0]))
             for n in metric_names}

    ck = os.path.join(tmp, "ckpt")
    cube, gt = synthetic_scene(DATA_ID)
    flags = ["--dataID", str(DATA_ID), "--data_root", tmp]
    labels = prepare_scene(DATA_ID, cube=cube, gt=gt, patch_size=W,
                           n_pc=N_PC, device="cpu").labels
    splits = generate_splits(labels, num_label=5)

    def import_and_map(outdir, ckpt):
        run_cli(export_model.main, flags + ["--import_run", bundle, outdir,
                                            "--checkpoint_dir", ckpt],
                counter_fn)
        require(not os.path.exists(os.path.join(
            ckpt, str(BUNDLE_STEPS), "generator.npy")),
            "the imported checkpoint holds a generator")
        pred, launches = predict_map(flags + [
            "--checkpoint_dir", ckpt, "--net", "b", "--n_PC", str(N_PC),
            "--w", str(W), "--val_batch_size", str(TILE),
            "--out", os.path.join(tmp, "bundle_map.svg")], counter_fn)
        return cal_accuracy(pred[splits.test], labels[splits.test] - 1), \
            launches

    acc, launches = import_and_map(out_runner, ck)
    acc_py = None
    if differ:
        out_py = os.path.join(tmp, "python_out")
        os.makedirs(out_py)
        for n, v in py.items():
            np.save(os.path.join(out_py, n + ".npy"), v)
        acc_py, _ = import_and_map(out_py, os.path.join(tmp, "ckpt_py"))
    hist = {n[len("metrics."):]: cpp[n] for n in metric_names}
    cls = hist["cls_loss"].mean(axis=1)
    report = {"phase": "train_bundle", "card": card_name_and_power(),
              "steps": BUNDLE_STEPS, **child["export"],
              "runner": runner,
              "ms_per_step": runner["run_ms_min"] / BUNDLE_STEPS,
              "python_package_run_ms": python_ms,
              "eager_cli_train_ms_per_step": eager["ms_per_step"],
              "runner_vs_python_bitwise": not differ,
              "runner_vs_python_outputs_differing": len(differ),
              "runner_vs_python_first_differing_step": first_diff,
              "runner_vs_python_step0_metrics": step0,
              "vs_eager_epoch_bitwise_params":
              child["vs_eager_bitwise_params"],
              "threefry_card_equals_cpu": child["threefry_card_equals_cpu"],
              "cls_loss_by_epoch": cls.tolist(),
              "oa_bundle_net_b": acc.oa,
              "oa_bundle_python_net_b": None if acc_py is None else acc_py.oa,
              "oa_eager_net_b": eager["oa"],
              "predict_launches": launches,
              "note": "synthetic PaviaU-size scene; ms_per_step is the "
                      "runner's run_ms_min (inputs' upload to outputs' "
                      "copy back) over the run's steps"}
    emit(report)
    require(launches == (406, 0), f"predict launches {launches}")
    require(cls[-1] < cls[0], f"bundle cls_loss by epoch {cls}")
    for n, (a, b) in step0.items():
        require(np.isclose(a, b, rtol=CARD_CPU_LOSS_RTOL,
                           atol=CARD_CPU_LOSS_ATOL),
                f"runner vs Python package, step 0 {n}: {a} vs {b}")
    for name, a in (("runner", acc), ("Python package", acc_py)):
        require(a is None or a.oa >= eager["oa"] - BUNDLE_OA_SLACK,
                f"the bundle's OA by the {name} {a and a.oa} < eager OA "
                f"{eager['oa']} - {BUNDLE_OA_SLACK}")

    # (f) the memory-bank bundle
    memo = child["memobank"]
    with open(os.path.join(memo["bundle"], "meta.json")) as f:
        mmeta = json.load(f)
    require(mmeta["num_epochs"] * mmeta["batches_per_epoch"]
            == MEMOBANK_BUNDLE_STEPS, f"memobank meta {mmeta}")
    require("state.bank.count" in mmeta["input_names"],
            "the memobank bundle carries no bank")
    out_memo = os.path.join(tmp, "runner_memobank_out")
    mrunner = run_host_io(memo["bundle"], os.path.join(memo["bundle"],
                                                       "inputs"),
                          out_memo, repeat=2, timeout=600)
    mout = {n: np.load(os.path.join(out_memo, n + ".npy"))
            for n in mmeta["output_names"]}
    for n, v in mout.items():
        require(np.all(np.isfinite(v)), f"memobank runner output {n} "
                "not finite")
    bank_count = mout["state.bank.count"]
    flags_memo = flags + list(MEMOBANK_BUNDLE)
    ck_memo = os.path.join(tmp, "ckpt_memobank")
    run_cli(export_model.main, flags_memo + [
        "--import_run", memo["bundle"], out_memo, "--checkpoint_dir",
        ck_memo], counter_fn)
    mpred, mlaunches = predict_map(flags + [
        "--checkpoint_dir", ck_memo, "--net", "b", "--n_PC", str(N_PC),
        "--w", str(W), "--val_batch_size", str(TILE),
        "--out", os.path.join(tmp, "bundle_memobank_map.svg")], counter_fn)
    macc = cal_accuracy(mpred[splits.test], labels[splits.test] - 1)
    mhist = mout["metrics.cls_loss"].mean(axis=1)
    mreport = {"phase": "train_bundle_memobank", "card":
               card_name_and_power(), "steps": MEMOBANK_BUNDLE_STEPS,
               **memo["export"], "runner": mrunner,
               "ms_per_step": mrunner["run_ms_min"] / MEMOBANK_BUNDLE_STEPS,
               "eager_memobank_epoch_ms_per_step":
               eager_memobank["ms_per_step"],
               "step1_grad_max_diff_of_tensor_max":
               child["memobank_step1_grad_max_diff_of_tensor_max"],
               "bank_count": bank_count.tolist(),
               "extra_loss_by_epoch":
               mout["metrics.extra_loss"].mean(axis=1).tolist(),
               "cls_loss_by_epoch": mhist.tolist(),
               "oa_bundle_net_b": macc.oa, "predict_launches": mlaunches,
               "note": "ms_per_step: the runner's run_ms_min over the "
                       "run's steps; the eager figure is phase extras' "
                       "one memobank epoch of cli.train"}
    emit(mreport)
    require(mlaunches == (406, 0), f"memobank predict launches {mlaunches}")
    require(int(bank_count.sum()) > 0, "the memobank run filled no bank")
    require(macc.oa > 0.5, f"the memobank bundle's OA {macc.oa}")
    return {"predict": launches[0], "predict_memobank": mlaunches[0],
            "ms_per_step": report["ms_per_step"]}


def phase_train_bundle_per_step(child: dict, tmp, pool_bundle: dict,
                                eager_per_step: dict, one_step: dict,
                                counter_fn) -> dict:
    """(c) The per-step bundle (kernel 1 twice a step inside the program,
    2 epochs) run by the C++ runner with the operators' library loaded
    (``run_host_io`` passes ``--op_library``; twice); its ``ms_per_step``
    beside the pool bundle's (``pool_bundle``, the same run) and the eager
    ``--gather_impl pallas`` epoch's (``eager_per_step``, phase
    ``train_pallas``); the runner's step-0 metrics at the card-vs-CPU loss
    bounds of the Python package's (``child``).  (d) ``--import_run`` of
    its outputs, mapped by ``predict --checkpoint_dir --net b``: OA over
    50.  ``one_step``: the per-step modes' one-step programs against the
    eager steps (:func:`per_step_steps_vs_eager`), reported here.  Returns
    the map's kernel-1 launches."""
    from cmlpl_tpu_torch.cli import export_model
    from cmlpl_tpu_torch.data.io import synthetic_scene
    from cmlpl_tpu_torch.data.prep import prepare_scene
    from cmlpl_tpu_torch.data.splits import generate_splits
    from cmlpl_tpu_torch.eval.metrics import cal_accuracy
    from cmlpl_tpu_torch.native.aoti_launcher import run_host_io

    bundle = child["bundle"]
    with open(os.path.join(bundle, "meta.json")) as f:
        meta = json.load(f)
    out = os.path.join(tmp, "runner_per_step_out")
    runner = run_host_io(bundle, os.path.join(bundle, "inputs"), out,
                         repeat=2, timeout=600)
    outs = {n: np.load(os.path.join(out, n + ".npy"))
            for n in meta["output_names"]}
    for n, v in outs.items():
        require(np.all(np.isfinite(v)), f"per-step runner output {n} not "
                "finite")
    step0 = {n: (float(outs[n].reshape(-1)[0]), child["step0"][n])
             for n in child["step0"]}
    flags = ["--dataID", str(DATA_ID), "--data_root", tmp]
    ck = os.path.join(tmp, "ckpt_per_step")
    run_cli(export_model.main, flags + list(PER_STEP_BUNDLE) + [
        "--import_run", bundle, out, "--checkpoint_dir", ck], counter_fn)
    pred, launches = predict_map(flags + [
        "--checkpoint_dir", ck, "--net", "b", "--n_PC", str(N_PC),
        "--w", str(W), "--val_batch_size", str(TILE),
        "--out", os.path.join(tmp, "bundle_per_step_map.svg")], counter_fn)
    cube, gt = synthetic_scene(DATA_ID)
    labels = prepare_scene(DATA_ID, cube=cube, gt=gt, patch_size=W,
                           n_pc=N_PC, device="cpu").labels
    splits = generate_splits(labels, num_label=5)
    acc = cal_accuracy(pred[splits.test], labels[splits.test] - 1)
    cls = outs["metrics.cls_loss"].mean(axis=1)
    report = {"phase": "train_bundle_per_step", "card": card_name_and_power(),
              "steps": PER_STEP_BUNDLE_STEPS, "gather_impl": "pallas",
              "custom_ops": meta["custom_ops"], **child["export"],
              "runner": runner,
              "ms_per_step": runner["run_ms_min"] / PER_STEP_BUNDLE_STEPS,
              "pool_bundle_ms_per_step": pool_bundle["ms_per_step"],
              "eager_pallas_epoch_ms_per_step":
              eager_per_step["pallas"]["ms_per_step"],
              "kernel_device_launches_python":
              child["kernel_device_launches"],
              "kernel_device_us_per_launch":
              child["kernel_device_us_per_launch"],
              "python_package_run_ms": child["python_package_run_ms"],
              "runner_vs_python_step0_metrics": step0,
              "one_step_programs_vs_eager": {
                  mode: {k: r[k] for k in (
                      "step1_grad_max_diff_of_tensor_max",
                      "program_launches", "export_s")}
                  for mode, r in one_step.items()},
              "cls_loss_by_epoch": cls.tolist(), "oa_bundle_net_b": acc.oa,
              "predict_launches": launches,
              "note": "ms_per_step: the runner's run_ms_min over the run's "
                      "steps; the pool bundle's is the 20-epoch run's, the "
                      "eager one phase train_pallas's epoch"}
    emit(report)
    for n, (a, b) in step0.items():
        require(np.isclose(a, b, rtol=CARD_CPU_LOSS_RTOL,
                           atol=CARD_CPU_LOSS_ATOL),
                f"per-step runner vs Python package, step 0 {n}: {a} vs {b}")
    require(launches == (406, 0), f"per-step predict launches {launches}")
    require(cls[-1] < cls[0], f"per-step bundle cls_loss by epoch {cls}")
    require(acc.oa > 0.5, f"the per-step bundle's OA {acc.oa}")
    return {"predict": launches[0]}


# -- multi-card data parallel (slice 12) ----------------------------------- #
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mh_trainer(algo: str, mesh=None, **cfg):
    from cmlpl_tpu_torch.train import CCTTrainer, CMLPLTrainer, CPSTrainer
    from cmlpl_tpu_torch.train.state import CMLPLConfig

    cls = {"cmlpl": CMLPLTrainer, "cps": CPSTrainer, "cct": CCTTrainer}[algo]
    return cls(CMLPLConfig(**cfg), device=torch.device("cuda"), mesh=mesh)


def whole_tensors(module, tensors: dict) -> dict:
    """name -> tensor of ``module``'s parameters (their gradients or
    themselves) on the host, the model axis's shards gathered whole when
    the module holds them (a collective of its model ranks)."""
    from cmlpl_tpu_torch.core.mesh import tp_gather_tree, tp_of
    from cmlpl_tpu_torch.weights import params_to_jax, state_dict_from_jax

    tp = tp_of(module)
    if tp is None:
        return {n: t.detach().cpu().clone() for n, t in tensors.items()}
    return state_dict_from_jax(tp_gather_tree(params_to_jax(tensors), tp))


def mh_step(trainer, tscene, batch, with_state: bool = False):
    """One step of ``trainer`` from ``init_state(SEED)`` on ``batch`` (the
    default schedule's first): (its metrics, its step-1 gradients, on the
    host; over a mesh the summed gradient, split ones gathered whole), and
    with ``with_state`` the state after it."""
    state = trainer.init_state(SEED)
    li, ly, ui = batch
    state, m = trainer.train_step(state, tscene, li, ly, ui, epoch=1)
    grads = []
    for mod in trainer._modules(state).values():
        named = dict(mod.named_parameters())
        whole = whole_tensors(mod, {n: p.grad for n, p in named.items()})
        grads += [whole[n] for n in named]
    out = {k: float(v) for k, v in m.items()}, grads
    return (out, state) if with_state else out


def hold_step(what: str, got, want, bf16: bool = False) -> dict:
    """Two steps from one state and one batch, held at the card's f32
    bounds (losses at CARD_CPU_LOSS_*, step-1 gradients within
    CARD_CPU_GRAD_TOL of each tensor's largest), or, in bf16, the losses
    at BF16_LOSS_* but the argmax decisions (BF16_DECISIONS)."""
    (mg, gg), (mw, gw) = got, want
    for k in mw:
        if bf16 and k in BF16_DECISIONS:
            continue
        rtol, atol = ((BF16_LOSS_RTOL, BF16_LOSS_ATOL) if bf16 else
                      (CARD_CPU_LOSS_RTOL, CARD_CPU_LOSS_ATOL))
        require(np.isfinite(mg[k]) and np.isclose(mg[k], mw[k], rtol=rtol,
                                                  atol=atol),
                f"{what}: {k} {mg[k]} vs {mw[k]}")
    gap = grad_gap(gg, gw)
    if not bf16:
        require(gap <= CARD_CPU_GRAD_TOL,
                f"{what}: step-1 gradients {gap} of a tensor's largest apart")
    return {"max_abs_diff": {k: abs(mg[k] - mw[k]) for k in mw},
            "step1_grad_max_diff_of_tensor_max": gap}


def state_digest(trainer, state) -> str:
    """sha256 of every tensor of a trainer state (params, Adam moments and
    steps, queues, bank, the generator's state and its next draw) and its
    step: equal digests are bitwise equal replicas."""
    h = hashlib.sha256()
    named = trainer.named_params(state)
    tensors = [p.detach() for p in named.values()]
    for opt in trainer._opts(state):
        for p in named.values():
            st = opt.state.get(p, {})
            tensors += [st[k] for k in sorted(st)]
    for name, c in sorted(trainer._carry(state).items()):
        fields = c.__dict__ if hasattr(c, "__dict__") else c._asdict()
        tensors += [torch.as_tensor(v) for _, v in sorted(fields.items())]
    tensors += [state.generator.get_state(),
                torch.rand(8, generator=state.generator,
                           device=state.generator.device)]
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    h.update(str(state.step).encode())
    return h.hexdigest()


def timed_all_reduce_ms(numel: int, device, rounds: int = 20,
                        group=None) -> float:
    """Host ms of one ``all_reduce`` of ``numel`` f32 on ``group`` (the
    default group: a step's flat gradient buffer), synchronised, after a
    warm-up."""
    import torch.distributed as dist

    buf = torch.ones(numel, device=device)
    dist.all_reduce(buf, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        dist.all_reduce(buf, group=group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / rounds * 1e3


#: the ZOO entries with a BatchNorm: one step of each over two ranks
ZOO_BN_MODELS = ("ssftt", "dbda", "dbda_feature", "ssrn", "fdssc", "msvit")
#: the zoo model of the multi-rank CLI runs (3-D BatchNorms, 100 steps)
MH_ZOO_MODEL = "ssrn"


def zoo_mh_scenes(cube, gt, device, names) -> dict:
    """The PaviaU-size scene at each of ``names``' own (w, n_pc), prepared
    once a shape: {name: scene}."""
    from cmlpl_tpu_torch.data.prep import prepare_scene

    shapes, scenes = zoo_shapes(), {}
    by_shape = {}
    for name in names:
        w, n_pc = shapes[name]
        if (w, n_pc) not in by_shape:
            by_shape[w, n_pc] = prepare_scene(DATA_ID, cube=cube, gt=gt,
                                              patch_size=w, n_pc=n_pc,
                                              device=device)
        scenes[name] = by_shape[w, n_pc]
    return scenes


def zoo_mh_trainer(name, scene, mesh=None, **kw):
    from cmlpl_tpu_torch.registry import get_dataset
    from cmlpl_tpu_torch.train.supervised import SupervisedTrainer

    return SupervisedTrainer(name, get_dataset(DATA_ID),
                             patch_size=scene.patch_size, n_pc=scene.n_pc,
                             device=scene.device, mesh=mesh, **kw)


def zoo_mh_step(name, scene, li, ly, mesh=None,
                with_state: bool = False) -> tuple:
    """One supervised step of ``name`` from ``init_state(SEED)`` on the
    ids ``li``, dropout off (its layers' rates set to 0) and no
    augmentation: (param names, loss, step-1 gradients, params, BN
    statistics), on the host; over a mesh the summed gradient and the
    replicated state, split tensors gathered whole; with ``with_state``,
    and (the trainer, the state after the step)."""
    from cmlpl_tpu_torch.models.common import Dropout

    trainer = zoo_mh_trainer(name, scene, mesh)
    state = trainer.init_state(SEED)
    for m in state.model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    state, m = trainer.train_step(state, scene, li, ly)
    named = dict(state.model.named_parameters())
    grads = whole_tensors(state.model, {
        n: torch.zeros_like(p) if p.grad is None else p.grad
        for n, p in named.items()})
    params = whole_tensors(state.model, named)
    out = (tuple(named), float(m["cls_loss"]), [grads[n] for n in named],
           [params[n] for n in named],
           {k: v.cpu().clone() for k, v in state.model.named_buffers()})
    return (out, (trainer, state)) if with_state else out


def hold_zoo_step(name: str, got, want) -> dict:
    """Two ranks' step against one rank's, both on the card: the losses at
    the card-vs-CPU bounds; the step-1 gradients, but those that are
    rounding only (a conv bias read only by train-mode BatchNorms: exact
    gradient 0), whose weights are held to Adam's reach after the step
    (2 lr), within CARD_CPU_GRAD_TOL of the model's largest gradient, as
    ``phase_zoo_card_vs_cpu`` holds them: the 3-D models' BatchNorm
    reductions cancel, and cuDNN sums them over 22 rows in another order
    than over 44 (each tensor's gap over its own largest is reported, with
    the tensor); the BN running statistics within CARD_CPU_GRAD_TOL of
    each tensor's largest."""
    (names, lg, gg, pg, sg), (_, lw, gw, pw, sw) = got, want
    require(np.isfinite(lg) and np.isclose(lg, lw, rtol=CARD_CPU_LOSS_RTOL,
                                           atol=CARD_CPU_LOSS_ATOL),
            f"{name}: two-rank loss {lg} vs one-rank {lw}")
    top = max(float(g.abs().max()) for g in gw)
    noise = [0 < float(g.abs().max()) < ROUNDING_ONLY * top for g in gw]
    kept = [(n_, a, b) for n_, a, b, n in zip(names, gg, gw, noise)
            if not n]
    diffs = [float((a - b).abs().max()) for _, a, b in kept]
    model_gap = max(diffs) / top
    require(model_gap <= CARD_CPU_GRAD_TOL,
            f"{name}: step-1 gradients {model_gap} of the model's largest "
            "apart")
    per_tensor = [d / max(float(b.abs().max()), 1e-30)
                  for d, (_, _, b) in zip(diffs, kept)]
    worst = int(np.argmax(per_tensor))
    reach = max((float((a - b).abs().max())
                 for a, b, n in zip(pg, pw, noise) if n), default=0.0)
    require(reach <= 2 * 5e-4,
            f"{name}: a rounding-only weight moved {reach} (reach 1e-3)")
    stats = max((float((sg[k] - sw[k]).abs().max())
                 / max(float(sw[k].abs().max()), 1e-12) for k in sw),
                default=0.0)
    require(stats <= CARD_CPU_GRAD_TOL,
            f"{name}: BN statistics {stats} of a tensor's largest apart")
    return {"loss_abs_diff": abs(lg - lw),
            "step1_grad_max_diff_of_model_max": model_gap,
            "step1_grad_max_diff_of_tensor_max": per_tensor[worst],
            "step1_grad_worst_tensor": kept[worst][0],
            "rounding_only_tensors": int(sum(noise)),
            "rounding_only_params_max_abs_diff": reach,
            "bn_stats_max_diff_of_tensor_max": stats}


def zoo_digest(state) -> str:
    """sha256 of a supervised state (the model's params and BN statistics,
    the EMA teacher's, the Adam moments and steps, the generator's state
    and its next draw) and its step."""
    h = hashlib.sha256()
    tensors = list(state.model.state_dict().values())
    if state.ema is not None:
        tensors += list(state.ema.state_dict().values())
    for p in state.model.parameters():
        st = state.opt.state.get(p, {})
        tensors += [st[k] for k in sorted(st)]
    tensors += [state.generator.get_state(),
                torch.rand(8, generator=state.generator,
                           device=state.generator.device)]
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    h.update(str(state.step).encode())
    return h.hexdigest()


def zoo_cli_run(tmp, counter_fn, extra=()) -> tuple:
    """``cli.train_backbone --model MH_ZOO_MODEL --num_epochs ZOO_EPOCHS``
    on dataID 1 with ``extra``, the gather counts reset first: (its
    accuracy, its report: train_s, ms_per_step, steps, map_s, kernel 1's
    launches in training and in the map)."""
    from cmlpl_tpu_torch.cli import train_backbone
    from cmlpl_tpu_torch.ops.patch_gather import WRAPPERS

    os.makedirs(tmp, exist_ok=True)
    for wrapper in WRAPPERS:
        wrapper.launches = 0
    acc, lines, counts = run_cli(train_backbone.main, [
        "--dataID", str(DATA_ID), "--model", MH_ZOO_MODEL, "--num_epochs",
        str(ZOO_EPOCHS), "--data_root", tmp, "--save_path_prefix", tmp,
        "--weights_out", os.path.join(tmp, f"{MH_ZOO_MODEL}.npz"), *extra],
        counter_fn)
    train_s, in_training = line_value(lines, counts, "training time")
    steps = int(re.search(r"\((\d+) steps\)", next(
        ln for ln in lines if ln.startswith("training time"))).group(1))
    map_s, at_map = line_value(lines, counts, "full-scene inference time")
    require(steps == ZOO_EPOCHS, f"{MH_ZOO_MODEL} CLI: {steps} steps")
    return acc, {"steps": steps, "train_s": train_s,
                 "ms_per_step": train_s / steps * 1e3, "map_s": map_s,
                 "launches_training": list(in_training),
                 "launches_map": [a - b for a, b in zip(at_map,
                                                        in_training)],
                 "oa": acc.oa}


def shared_card_zoo(mesh, cube, gt, device, tmp) -> dict:
    """The zoo over the two ranks of :func:`run_shared_card_rank`: one step
    of each ZOO_BN_MODELS entry against the one-rank step (rank 0), 3
    steps of SSFTT with its dropout and the augmentations on (the
    replicas' digest), kernel 1 a step over 5 SSRN steps under the
    profiler, and ``cli.train_backbone --multihost --model ssrn`` (100
    epochs): its training and strip map's launches, its map recorded and,
    on rank 0, held bitwise to the one-rank map of its weights."""
    from cmlpl_tpu_torch.data.splits import generate_splits
    from cmlpl_tpu_torch.eval.inference import ScenePredictor
    from cmlpl_tpu_torch.models.zoo import build_model
    from cmlpl_tpu_torch.ops.patch_gather import WRAPPERS
    from cmlpl_tpu_torch.registry import get_dataset
    from cmlpl_tpu_torch.train.supervised import schedule
    from cmlpl_tpu_torch.weights import (load_params_npz,
                                         zoo_state_dict_from_jax)

    def counter_fn():
        return tuple(w.launches for w in WRAPPERS)

    out = {"steps": {}}
    scenes = zoo_mh_scenes(cube, gt, device, ZOO_BN_MODELS)
    labels = gt.reshape(-1).astype(np.int32)
    train = generate_splits(labels, num_label=5).train
    # 45 labels on 2 ranks: batches of 44
    li, ly = schedule(train, labels, ZOO_BATCH, 3, None, 1088, data=2)
    out["batch"] = int(li.shape[1])
    for wrapper in WRAPPERS:
        wrapper.launches = 0
    for name in ZOO_BN_MODELS:
        two = zoo_mh_step(name, scenes[name], li[0], ly[0], mesh)
        if mesh.rank == 0:
            out["steps"][name] = hold_zoo_step(
                name, two, zoo_mh_step(name, scenes[name], li[0], ly[0]))
    out["step_launches"] = list(counter_fn())
    # dropout and the augmentations on, an EMA teacher: the replicas
    trainer = zoo_mh_trainer("ssftt", scenes["ssftt"], mesh, augment=True,
                             ema_alpha=0.95)
    state = trainer.init_state(SEED)
    state, _ = trainer.train_run(state, scenes["ssftt"], li, ly)
    out["ssftt_digest"] = zoo_digest(state)
    # kernel 1 once a step on each rank, counted by the profiler
    trainer = zoo_mh_trainer(MH_ZOO_MODEL, scenes[MH_ZOO_MODEL], mesh)
    state = trainer.init_state(SEED)
    five_li, five_ly = schedule(train, labels, ZOO_BATCH, 5, None, 7, data=2)
    _, counts, _ = profiled(lambda: trainer.train_run(
        state, scenes[MH_ZOO_MODEL], five_li, five_ly), [()])
    out["profiled_5_steps_launches"] = sum(
        n for k, n in counts.items() if KERNEL_NEEDLE in k)
    # the CLI over the two ranks; its map, as ScenePredictor returned it
    maps = []
    call = ScenePredictor.__call__

    def recording(self, scene):
        labels_ = call(self, scene)
        maps.append(labels_)
        return labels_

    ScenePredictor.__call__ = recording
    try:
        acc, out["cli"] = zoo_cli_run(os.path.join(tmp, "zoo_cli"),
                                      counter_fn, ["--multihost"])
    finally:
        ScenePredictor.__call__ = call
    require(len(maps) == 1, f"{len(maps)} maps recorded")
    out["cli_map_digest"] = hashlib.sha256(maps[0].tobytes()).hexdigest()
    if mesh.rank == 0:
        scene = scenes[MH_ZOO_MODEL]
        model, _ = build_model(MH_ZOO_MODEL, get_dataset(DATA_ID),
                               scene.n_pc, scene.patch_size)
        model.load_state_dict(zoo_state_dict_from_jax(
            MH_ZOO_MODEL, load_params_npz(os.path.join(
                tmp, "zoo_cli", f"{MH_ZOO_MODEL}.npz"))))
        model = model.to(device).eval()
        one = ScenePredictor(lambda xp, x: model(xp),
                             patch_size=scene.patch_size, cols=scene.cols,
                             tile=TILE, gather="pallas",
                             spectra=False)(scene)
        out["cli_map_equals_one_rank_map"] = bool(np.array_equal(maps[0],
                                                                 one))
    return out


#: serve --multihost's cases on the two gloo ranks: the default gather
#: (auto: kernel 1) with its warm-up, kernel 2 and dense
MH_SERVE = {"auto": [], "pallas_bf16": ["--eval_gather", "pallas_bf16",
                                        "--no_warmup"],
            "dense": ["--eval_gather", "dense", "--no_warmup"]}
#: a prepared PaviaU scene's bytes (the padded f32 PCA cube, the f32
#: spectra, the int32 labels): what broadcast_scene carries
SCENE_BYTES = ((610 + W) * (340 + W) * N_PC + 610 * 340 * 103
               + 610 * 340) * 4


def serve_inputs(tmp, cube, write: bool) -> tuple:
    """(the serving argv: ``--data_root tmp``, PaviaU width, tiles of
    TILE; ``--weights``: random BaseNet2 weights from SEED) and, with
    ``write``, those weights, ``cube`` as ``tmp/paviau.npy`` and a small
    cube of 102 bands as ``tmp/bands.npy`` written now."""
    from cmlpl_tpu_torch.registry import get_dataset
    from cmlpl_tpu_torch.weights import init_basenet2_params, save_params_npz

    weights = os.path.join(tmp, "w.npz")
    if write:
        os.makedirs(tmp, exist_ok=True)
        spec = get_dataset(DATA_ID)
        save_params_npz(weights, init_basenet2_params(
            SEED, n_pc=N_PC, num_features=spec.num_bands,
            num_classes=spec.num_classes, patch_size=W))
        np.save(os.path.join(tmp, "paviau.npy"), cube)
        np.save(os.path.join(tmp, "bands.npy"), cube[:16, :16, :102])
    return ["--dataID", str(DATA_ID), "--n_PC", str(N_PC), "--w", str(W),
            "--val_batch_size", str(TILE), "--data_root", tmp], weights


def serve_requests(tmp, out_dir) -> str:
    """serve's stdin: the PaviaU-size cube of :func:`serve_inputs`, its
    labels to ``out_dir/good.npy``, a request for a missing cube and one
    for the cube of 102 bands (refused on rank 0)."""
    return "".join(json.dumps(r) + "\n" for r in (
        {"id": "good", "cube": os.path.join(tmp, "paviau.npy"),
         "out": os.path.join(out_dir, "good.npy")},
        {"id": "bad", "cube": os.path.join(tmp, "missing.npy"),
         "out": os.path.join(out_dir, "bad.npy")},
        {"id": "bands", "cube": os.path.join(tmp, "bands.npy"),
         "out": os.path.join(out_dir, "bands.npy")}))


def serve_run(argv, stdin_text: str) -> dict:
    """``cli.serve.main(argv)`` on ``stdin_text`` with all it writes to
    stdout captured: its response lines (each one JSON) and the kernel
    launches (both wrappers) between them, how far it read its stdin, its
    scene broadcasts (calls, bytes, host ms a call), each wrapper's
    launches and the wall s."""
    from cmlpl_tpu_torch.cli import serve
    from cmlpl_tpu_torch.core.mesh import SCENE_BROADCASTS
    from cmlpl_tpu_torch.ops.patch_gather import WRAPPERS

    for wrapper in WRAPPERS:
        wrapper.launches = 0
    SCENE_BROADCASTS.reset()
    stdin = io.StringIO(stdin_text)
    log = ResponseLog(lambda: sum(w.launches for w in WRAPPERS))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        serve.main(argv, stdin=stdin)
    wall_s = time.perf_counter() - t0
    b = SCENE_BROADCASTS
    return {"responses": [json.loads(ln)
                          for ln in log.getvalue().splitlines()],
            "stdout_chars": len(log.getvalue()),
            "launches_per_line": np.diff([0] + log.counts).tolist(),
            "stdin_read": stdin.tell(),
            "broadcasts": {"calls": b.calls, "bytes": b.bytes,
                           "ms_per_call": b.seconds * 1e3 / max(b.calls, 1)},
            "launches": [w.launches for w in WRAPPERS], "wall_s": wall_s}


def hold_serve(what: str, run: dict, maps: int, launches: list,
               primary: bool) -> None:
    """A serve run of :func:`serve_run` on :func:`serve_requests`: rank 0
    answered ready, the good request and the two bad ones (errors), the
    other ranks wrote and read nothing; ``maps`` scene broadcasts of
    SCENE_BYTES each (none without a group), and the wrappers'
    ``launches``."""
    require(run["launches"] == launches,
            f"{what}: launches {run['launches']}, want {launches}")
    require(run["broadcasts"]["calls"] == maps
            and run["broadcasts"]["bytes"] == maps * SCENE_BYTES,
            f"{what}: scene broadcasts {run['broadcasts']}, want {maps}")
    if not primary:
        require(run["stdout_chars"] == 0 and run["stdin_read"] == 0,
                f"{what}: a rank other than 0 wrote {run['stdout_chars']} "
                f"characters to stdout and read {run['stdin_read']} of "
                "stdin")
        return
    res = run["responses"]
    require(len(res) == 4 and res[0].get("ready") is True
            and res[1].get("id") == "good" and "error" not in res[1]
            and res[1].get("pixels") == 610 * 340
            and "FileNotFoundError" in res[2].get("error", "")
            and res[3].get("id") == "bands"
            and res[3].get("error", "").startswith("ValueError"),
            f"{what}: responses {res}")


def shared_card_serve(mesh, cube, device, tmp, trainer, state) -> dict:
    """``serve --multihost`` and ``predict --multihost`` on the two gloo
    ranks of :func:`run_shared_card_rank`, the files under ``tmp``: serve
    of random BaseNet2 weights on each MH_SERVE case's requests (the
    default, kernel 1, with its warm-up, and kernel 2 under the
    profiler), rank 0's
    good-request labels held to the one-rank map of the same weights and
    scene, prepared on the card as serve prepares it (bitwise; dense
    tie-safe); then ``predict --multihost
    --checkpoint_dir`` of the 2-epoch run's checkpoint, its map on rank 0
    held bitwise to the one-rank ``predict``'s."""
    from cmlpl_tpu_torch.cli import predict
    from cmlpl_tpu_torch.cli._common import logits_fn
    from cmlpl_tpu_torch.core.mesh import barrier
    from cmlpl_tpu_torch.data.prep import prepare_scene
    from cmlpl_tpu_torch.eval.inference import (ScenePredictor,
                                                dense_scene_logits)
    from cmlpl_tpu_torch.models.basenet import BaseNet2
    from cmlpl_tpu_torch.ops.patch_gather import WRAPPERS
    from cmlpl_tpu_torch.registry import get_dataset
    from cmlpl_tpu_torch.utils.checkpoint import save_checkpoint
    from cmlpl_tpu_torch.weights import load_params_npz, state_dict_from_jax

    files = os.path.join(tmp, "serve")
    primary = mesh.rank == 0
    common, weights = serve_inputs(files, cube, write=primary)
    ckpt = os.path.join(files, "ckpt")
    save_checkpoint(ckpt, trainer, state)
    barrier(mesh)
    out = {"serve": {}}
    for name, extra in MH_SERVE.items():
        out_dir = os.path.join(files, name)
        os.makedirs(out_dir, exist_ok=True)
        argv = common + ["--weights", weights, "--multihost", "--device",
                         "cuda", *extra]
        maps = 2 if name == "auto" else 1   # the warm-up's map too
        want = {"auto": [2 * 203, 0], "pallas_bf16": [0, 203],
                "dense": [0, 0]}[name]
        if name == "dense":     # no kernel to count
            run = serve_run(argv, serve_requests(files, out_dir))
        else:
            # the whole run in one session: the records CUPTI may drop
            # at a session's start (profiled waits for them) are then
            # never a map's
            box = {}
            _, counts, _ = profiled(lambda: box.update(run=serve_run(
                argv, serve_requests(files, out_dir))), [()])
            run = box["run"]
            run["kernel_launches_profiler"] = sum(
                n for k, n in counts.items() if KERNEL_NEEDLE in k)
            require(run["kernel_launches_profiler"] == sum(want),
                    f"serve --multihost {name}, rank {mesh.rank}: the "
                    f"profiler saw {run['kernel_launches_profiler']} "
                    "launches")
        hold_serve(f"serve --multihost {name}, rank {mesh.rank}", run,
                   maps, want, primary)
        out["serve"][name] = run
    if primary:
        spec = get_dataset(DATA_ID)
        model = BaseNet2(num_features=spec.num_bands,
                         num_classes=spec.num_classes, n_pc=N_PC,
                         patch_size=W)
        model.load_state_dict(state_dict_from_jax(load_params_npz(weights)))
        model = model.to(device).eval()
        # serve prepares the scene on the card, as here
        scene = prepare_scene(DATA_ID, cube=cube,
                              gt=np.zeros(cube.shape[:2], np.int64),
                              patch_size=W, n_pc=N_PC, device=device,
                              on_card=True)
        for name in MH_SERVE:
            got = np.load(os.path.join(files, name, "good.npy"))
            gather = "pallas" if name == "auto" else name
            one = ScenePredictor(logits_fn(model), params=model.state_dict(),
                                 patch_size=W, cols=scene.cols, tile=TILE,
                                 gather=gather)(scene)
            if name == "dense":
                with torch.inference_mode():
                    logits = dense_scene_logits(model.state_dict(), scene)
                tie_safe_equal(got, one, lambda ids: logits[
                    torch.from_numpy(ids).to(device)],
                    "serve --multihost dense vs the one-rank dense map")
            else:
                require(np.array_equal(got, one),
                        f"serve --multihost {name}: the labels are not "
                        "bitwise the one-rank map")
            out["serve"][name]["differing_pixels_vs_one_rank"] = int(
                (got != one).sum())
    # predict --multihost of the run's checkpoint, then on rank 0 alone
    argv = common + ["--checkpoint_dir", ckpt, "--device", "cuda"]
    outs = [os.path.join(files, f"predict_{r}.svg") for r in range(2)]
    for wrapper in WRAPPERS:
        wrapper.launches = 0
    labels, lines, _ = run_cli(predict.main, argv + [
        "--multihost", "--out", outs[mesh.rank]], lambda: 0)
    out["predict_launches"] = [w.launches for w in WRAPPERS]
    require(out["predict_launches"] == [203, 0],
            f"predict --multihost, rank {mesh.rank}: launches "
            f"{out['predict_launches']}")
    require(("multihost: 2 process(es)" in lines)
            and any(ln.startswith(" OA=") for ln in lines),
            f"predict --multihost printed {lines[-6:]}")
    out["predict_digest"] = hashlib.sha256(labels.tobytes()).hexdigest()
    barrier(mesh)
    if primary:
        one, _, _ = run_cli(predict.main, argv + [
            "--out", os.path.join(files, "predict_one.svg")], lambda: 0)
        require(np.array_equal(labels, one),
                "predict --multihost --checkpoint_dir: the map is not "
                "bitwise the one-rank predict's")
        require(not os.path.exists(outs[1]), "rank 1 wrote --out")
        with open(outs[0], "rb") as f, \
                open(os.path.join(files, "predict_one.svg"), "rb") as g:
            require(f.read() == g.read(),
                    "predict --multihost: rank 0's --out differs")
    return out


def run_shared_card_rank(tmp) -> dict:
    """One of two gloo ranks on ``cuda:0`` (torchrun's environment set by
    :func:`phase_multihost_shared_card`), through the library: gloo's
    collectives on CUDA tensors; a noise-off step of CMLPL, CPS and CCT
    (rank 0 also takes the one-rank step), 3 noise-on steps' state digest;
    a bf16 CMLPL step (kernel 2's pool); CMLPL steps with an "auto" pool
    over the budget (kernel 1 twice a step); a 2-epoch CMLPL run (one pool),
    its net B's map (one strip of 203 tiles a rank, counted by the wrapper
    and by the profiler; rank 0 also maps the whole scene on one rank) and
    its dense map in strips of scene rows (rank 0 also maps it whole), a
    one-step call's pool under the profiler, a step's all-reduce; then
    the zoo (:func:`shared_card_zoo`) and serve and predict over the
    ranks (:func:`shared_card_serve`), their CLIs' files under ``tmp``."""
    import torch.distributed as dist

    from cmlpl_tpu_torch.cli._common import logits_fn
    from cmlpl_tpu_torch.core.mesh import create_mesh, initialize_multihost
    from cmlpl_tpu_torch.data.io import synthetic_scene
    from cmlpl_tpu_torch.data.pipeline import SemiSupervisedSampler
    from cmlpl_tpu_torch.data.prep import prepare_scene
    from cmlpl_tpu_torch.data.splits import generate_splits
    from cmlpl_tpu_torch.eval.inference import ScenePredictor
    from cmlpl_tpu_torch.eval.metrics import cal_accuracy
    from cmlpl_tpu_torch.ops.patch_gather import (WRAPPERS,
                                                  gather_patches_bf16,
                                                  gather_patches_f32)

    device = torch.device("cuda:0")
    require(initialize_multihost(backend="gloo", device=device) == 2,
            "not a world of two")
    mesh = create_mesh(device)
    require((mesh.size, mesh.backend) == (2, "gloo"), f"mesh {mesh}")
    out = {"rank": mesh.rank}
    # gloo on CUDA tensors: the two collectives the mesh uses
    t = torch.full((4,), mesh.rank + 1.0, device=device)
    dist.all_reduce(t)
    b = torch.full((16,), mesh.rank, dtype=torch.uint8, device=device)
    dist.broadcast(b, src=1)
    out["gloo_cuda"] = {"all_reduce_f32": t.tolist()[0],
                        "broadcast_uint8": int(b[0])}
    cube, gt = synthetic_scene(DATA_ID)
    tscene = prepare_scene(DATA_ID, cube=cube, gt=gt, patch_size=W,
                           n_pc=N_PC, device=device)
    li, ly, ui = (a[0] for a in default_schedule(tscene.labels, 1))
    first = (li[0], ly[0], ui[0])
    off = dict(noise=0.0, dropout=0.0, gather_impl="pool")
    out["steps"], out["digests"] = {}, {}
    for algo in ("cmlpl", "cps", "cct"):
        two = mh_step(mh_trainer(algo, mesh, **off), tscene, first)
        if mesh.rank == 0:
            out["steps"][algo] = hold_step(
                f"{algo}: two ranks vs one rank on the card", two,
                mh_step(mh_trainer(algo, **off), tscene, first))
        trainer = mh_trainer(algo, mesh)
        state = trainer.init_state(SEED)
        state, _ = trainer.train_epoch(state, tscene, li[:3], ly[:3],
                                       ui[:3], 1)
        out["digests"][algo] = state_digest(trainer, state)
    for wrapper in WRAPPERS:
        wrapper.launches = 0
    bf16 = dict(off, compute_dtype="bfloat16")
    two = mh_step(mh_trainer("cmlpl", mesh, **bf16), tscene, first)
    out["bf16_launches"] = [w.launches for w in WRAPPERS]
    if mesh.rank == 0:
        out["bf16_step"] = hold_step(
            "bf16 cmlpl: two ranks vs one rank on the card", two,
            mh_step(mh_trainer("cmlpl", **bf16), tscene, first), bf16=True)
    # an "auto" whose pool is over the budget: kernel 1 each step on each
    # rank, which gathers its whole batch (labeled, unlabeled: 2 a step)
    over = dict(off, gather_impl="auto", num_unlabel=OVER_BUDGET_UNLABEL)
    trainer = mh_trainer("cmlpl", mesh, **over)
    out["over_budget_impl"] = trainer.config.gather_impl
    for wrapper in WRAPPERS:
        wrapper.launches = 0
    two = mh_step(trainer, tscene, first)
    out["over_budget_step_launches"] = [w.launches for w in WRAPPERS]
    for wrapper in WRAPPERS:
        wrapper.launches = 0
    trainer.train_epoch(trainer.init_state(SEED), tscene, li[:3], ly[:3],
                        ui[:3], 1)
    out["over_budget_3_step_launches"] = [w.launches for w in WRAPPERS]
    if mesh.rank == 0:
        out["over_budget_step"] = hold_step(
            "over-budget auto cmlpl: two ranks vs one rank on the card",
            two, mh_step(mh_trainer("cmlpl", **over), tscene, first))

    # the 2-epoch run, through the library
    trainer = mh_trainer("cmlpl", mesh, num_epochs=2)
    state = trainer.init_state(SEED)
    sampler = SemiSupervisedSampler(generate_splits(tscene.labels,
                                                    num_label=5),
                                    tscene.labels, 128, 128, 10000,
                                    seed=1088)
    for wrapper in WRAPPERS:
        wrapper.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, history = trainer.fit(state, tscene, sampler, log_every=0)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["steps_run"] = len(history)
    out["train_launches"] = [w.launches for w in WRAPPERS]
    out["run_digest"] = state_digest(trainer, state)
    model = state.net_b.model.eval()
    predictor = ScenePredictor(logits_fn(model), patch_size=W,
                               cols=tscene.cols, tile=TILE, gather="pallas",
                               mesh=mesh)
    for wrapper in WRAPPERS:
        wrapper.launches = 0
    labels = predictor(tscene)
    out["map_launches"] = [w.launches for w in WRAPPERS]
    _, counts, _ = profiled(predictor, [(tscene,)])
    out["map_kernel_launches_profiler"] = sum(
        n for k, n in counts.items() if KERNEL_NEEDLE in k)
    splits = generate_splits(tscene.labels, num_label=5)
    out["oa_net_b"] = cal_accuracy(labels[splits.test],
                                   tscene.labels[splits.test] - 1).oa
    out["labels_digest"] = hashlib.sha256(labels.tobytes()).hexdigest()
    if mesh.rank == 0:
        one = ScenePredictor(logits_fn(model), patch_size=W,
                             cols=tscene.cols, tile=TILE,
                             gather="pallas")(tscene)
        out["map_equals_one_rank_map"] = bool(np.array_equal(labels, one))
    # the dense map in strips of scene rows: no gather launch
    from cmlpl_tpu_torch.eval.inference import dense_scene_logits

    for wrapper in WRAPPERS:
        wrapper.launches = 0
    dense = ScenePredictor(None, patch_size=W, cols=tscene.cols,
                           gather="dense", params=model.state_dict(),
                           mesh=mesh)(tscene)
    out["dense_launches"] = [w.launches for w in WRAPPERS]
    out["dense_digest"] = hashlib.sha256(dense.tobytes()).hexdigest()
    if mesh.rank == 0:
        whole = ScenePredictor(None, patch_size=W, cols=tscene.cols,
                               gather="dense",
                               params=model.state_dict())(tscene)
        with torch.inference_mode():
            logits = dense_scene_logits(model.state_dict(), tscene)
        tie_safe_equal(dense, whole, lambda ids: logits[torch.from_numpy(
            ids).to(device)], "two-rank dense map vs the one-rank one")
        out["dense_differing_pixels"] = int((dense != whole).sum())
        out["dense_oa_net_b"] = cal_accuracy(
            dense[splits.test], tscene.labels[splits.test] - 1).oa
    # a one-step call's pool under the profiler: one kernel-1 launch
    pool_trainer = mh_trainer("cmlpl", mesh)
    pool_state = pool_trainer.init_state(SEED)
    _, counts, _ = profiled(lambda: pool_trainer.train_step(
        pool_state, tscene, *first, epoch=1), [()])
    out["pool_kernel_launches_profiler"] = sum(
        n for k, n in counts.items() if KERNEL_NEEDLE in k)
    # a step's gradient all-reduce over gloo (through the host)
    numel = sum(p.numel() for p in trainer.named_params(state).values())
    out["all_reduce"] = {"bytes": numel * 4,
                         "ms": timed_all_reduce_ms(numel, device)}
    out["zoo"] = shared_card_zoo(mesh, cube, gt, device, tmp)
    out["serve"] = shared_card_serve(mesh, cube, device, tmp, trainer, state)
    dist.destroy_process_group()
    return out


def start_shared_card(tmp):
    """The two ranks of :func:`run_shared_card_rank`, started now."""
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": "2", "LOCAL_RANK": "0"}
    return [start_child(os.path.join(tmp, f"rank{r}"),
                        "run_shared_card_rank", os.path.join(tmp, "files"),
                        env=dict(env, RANK=str(r)))
            for r in range(2)]


def phase_multihost_shared_card(children) -> dict:
    """Two gloo ranks on one card (``multihost_shared_card``): every hold
    of :func:`run_shared_card_rank`; returns the launches a rank."""
    ranks = [finish_child(c) for c in children]
    r0, r1 = ranks
    for r in ranks:
        require(r["gloo_cuda"] == {"all_reduce_f32": 3.0,
                                   "broadcast_uint8": 1},
                f"gloo on CUDA tensors: {r['gloo_cuda']}")
        require(r["train_launches"] == [1, 0],
                f"rank {r['rank']}: 2-epoch run launches "
                f"{r['train_launches']}")
        require(r["map_launches"] == [203, 0]
                and r["map_kernel_launches_profiler"] == 203,
                f"rank {r['rank']}: map launches {r['map_launches']}, "
                f"profiler {r['map_kernel_launches_profiler']}")
        require(r["pool_kernel_launches_profiler"] == 1,
                f"rank {r['rank']}: pool launches (profiler) "
                f"{r['pool_kernel_launches_profiler']}")
        require(r["bf16_launches"] == [0, 1],
                f"rank {r['rank']}: bf16 step launches {r['bf16_launches']}")
        require(r["over_budget_impl"] == "pallas"
                and r["over_budget_step_launches"] == [2, 0]
                and r["over_budget_3_step_launches"] == [6, 0],
                f"rank {r['rank']}: over-budget auto "
                f"{r['over_budget_impl']}, launches a step "
                f"{r['over_budget_step_launches']}, over 3 steps "
                f"{r['over_budget_3_step_launches']}")
        require(r["steps_run"] == 156, f"steps {r['steps_run']}")
        require(r["dense_launches"] == [0, 0],
                f"rank {r['rank']}: dense map launches {r['dense_launches']}")
        z = r["zoo"]
        n_zoo = len(ZOO_BN_MODELS)
        require(z["batch"] == 44, f"zoo batch {z['batch']} on two ranks")
        require(z["step_launches"] == [2 * n_zoo if r["rank"] == 0
                                       else n_zoo, 0],
                f"rank {r['rank']}: zoo steps' launches "
                f"{z['step_launches']}")
        require(z["profiled_5_steps_launches"] == 5,
                f"rank {r['rank']}: {MH_ZOO_MODEL} 5 steps, kernel 1 "
                f"{z['profiled_5_steps_launches']} times (profiler)")
        require(z["cli"]["launches_training"] == [ZOO_EPOCHS, 0]
                and z["cli"]["launches_map"] == [203, 0],
                f"rank {r['rank']}: train_backbone --multihost launches "
                f"{z['cli']}")
    for key in ("digests", "run_digest", "labels_digest", "oa_net_b",
                "dense_digest"):
        require(r0[key] == r1[key], f"the ranks differ in {key}: "
                f"{r0[key]} vs {r1[key]}")
    for key in ("ssftt_digest", "cli_map_digest"):
        require(r0["zoo"][key] == r1["zoo"][key],
                f"the ranks differ in zoo {key}")
    require(r0["zoo"]["cli"]["oa"] == r1["zoo"]["cli"]["oa"],
            f"train_backbone --multihost OA {r0['zoo']['cli']['oa']} vs "
            f"{r1['zoo']['cli']['oa']}")
    require(r0["zoo"]["cli_map_equals_one_rank_map"],
            "train_backbone --multihost: the strip map is not bitwise the "
            "one-rank map of its weights")
    require(set(r0["zoo"]["steps"]) == set(ZOO_BN_MODELS),
            f"zoo steps held: {sorted(r0['zoo']['steps'])}")
    require(r0["map_equals_one_rank_map"],
            "the two-rank map is not bitwise the one-rank map")
    require(r0["oa_net_b"] > 0.5, f"OA net B {r0['oa_net_b']}")
    s0, s1 = r0["serve"], r1["serve"]
    require(s0["predict_digest"] == s1["predict_digest"],
            "predict --multihost: the ranks' maps differ")
    require(s0["serve"]["auto"]["launches_per_line"] == [203, 203, 0, 0]
            and s0["serve"]["pallas_bf16"]["launches_per_line"]
            == [0, 203, 0, 0],
            "serve --multihost: rank 0's launches a response "
            f"{ {k: v['launches_per_line'] for k, v in s0['serve'].items()} }")
    emit({"phase": "multihost_shared_card", "ranks": 2, "backend": "gloo",
          "device": "cuda:0 (both ranks)",
          "gloo_cuda_tensors": r0["gloo_cuda"],
          "one_step_vs_one_rank": r0["steps"],
          "bf16_step_vs_one_rank": r0["bf16_step"],
          "over_budget_auto": {
              "num_unlabel": OVER_BUDGET_UNLABEL,
              "gather_impl": [r["over_budget_impl"] for r in ranks],
              "launches_one_step": [r["over_budget_step_launches"]
                                    for r in ranks],
              "launches_3_steps": [r["over_budget_3_step_launches"]
                                   for r in ranks],
              "step_vs_one_rank": r0["over_budget_step"]},
          "replicas_bitwise_equal_after_3_steps": True,
          "epochs": 2, "train_s": [r["train_s"] for r in ranks],
          "ms_per_step": [r["train_s"] / 156 * 1e3 for r in ranks],
          "ms_per_step_note": "two ranks share one card: not a speed "
                              "figure",
          "all_reduce_per_step": [r["all_reduce"] for r in ranks],
          "launches_per_rank": [{"pool": r["train_launches"][0],
                                 "map": r["map_launches"][0],
                                 "bf16_pool": r["bf16_launches"][1]}
                                for r in ranks],
          "map_equals_one_rank_map": True, "oa_net_b": r0["oa_net_b"],
          "dense_map": {"launches": r0["dense_launches"],
                        "differing_pixels_vs_one_rank":
                        r0["dense_differing_pixels"],
                        "oa_net_b": r0["dense_oa_net_b"]}})
    emit({"phase": "multihost_shared_card_serve", "ranks": 2,
          "backend": "gloo", "scene": "synthetic_scene(1), 610 x 340 x 103",
          "weights": f"random BaseNet2 from seed {SEED}",
          "serve": {name: {
              "latency_s": s0["serve"][name]["responses"][1]["latency_s"],
              "warmup_s": s0["serve"][name]["responses"][0].get("warmup_s"),
              "scene_broadcast": {
                  "calls": s0["serve"][name]["broadcasts"]["calls"],
                  "bytes_per_call": SCENE_BYTES,
                  "ms_per_call_per_rank": [
                      r["serve"]["serve"][name]["broadcasts"]["ms_per_call"]
                      for r in ranks]},
              "launches_per_rank": [r["serve"]["serve"][name]["launches"]
                                    for r in ranks],
              "kernel_launches_profiler_per_rank": [
                  r["serve"]["serve"][name].get("kernel_launches_profiler")
                  for r in ranks],
              "launches_per_response_rank0":
              s0["serve"][name]["launches_per_line"],
              "differing_pixels_vs_one_rank":
              s0["serve"][name]["differing_pixels_vs_one_rank"],
              "wall_s_per_rank": [r["serve"]["serve"][name]["wall_s"]
                                  for r in ranks]}
              for name in MH_SERVE},
          "rank1_stdout_chars": [s1["serve"][n]["stdout_chars"]
                                 for n in MH_SERVE],
          "predict_checkpoint": {
              "launches_per_rank": [r["serve"]["predict_launches"]
                                    for r in ranks],
              "map_equals_one_rank_predict": True},
          "note": "two ranks share one card and gloo carries the scene "
                  "through the host, and the runs of kernels 1 and 2 are "
                  "profiled: latency_s and the broadcast's ms are not a "
                  "speed figure"})
    z0 = r0["zoo"]
    emit({"phase": "multihost_shared_card_zoo", "ranks": 2,
          "backend": "gloo", "batch": z0["batch"],
          "one_step_vs_one_rank": z0["steps"],
          "ssftt_dropout_augment_3_steps_replicas_equal": True,
          "profiled_5_steps_kernel1": [r["zoo"]["profiled_5_steps_launches"]
                                       for r in ranks],
          "cli": [r["zoo"]["cli"] for r in ranks],
          "cli_map_equals_one_rank_map": True,
          "ms_per_step_note": "two ranks share one card: not a speed "
                              "figure"})
    return {"train": r0["train_launches"][0], "map": r0["map_launches"][0],
            "bf16": r0["bf16_launches"][1],
            "over_budget": r0["over_budget_3_step_launches"][0],
            "zoo_steps": r0["zoo"]["step_launches"][0],
            "zoo_train": r0["zoo"]["cli"]["launches_training"][0],
            "zoo_map": r0["zoo"]["cli"]["launches_map"][0],
            "serve": s0["serve"]["auto"]["launches_per_line"][1],
            "serve_bf16": s0["serve"]["pallas_bf16"]["launches_per_line"][1],
            "predict": s0["predict_launches"][0]}


#: the model axis of the 2-D mesh of four gloo ranks on one card (2 x 2)
TP = 2
#: the one-step cases on the 2-D mesh: trainer and config (noise and
#: dropout off, pool gather), or a zoo model for the supervised trainer
TP_STEPS = {"cmlpl": ("cmlpl", {}),
            "cmlpl_bf16": ("cmlpl", {"compute_dtype": "bfloat16"}),
            "cmlpl_memobank": ("cmlpl", {"extra_loss": "memobank"}),
            "cps": ("cps", {}), "cct": ("cct", {})}
TP_ZOO = ("basenet2", "basenet2_zoo", "basenet1", "ssrn")


def tree_digest(tree) -> str:
    """sha256 of a nested tree of arrays, by sorted path."""
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node, key=str):
                walk(node[k], f"{path}/{k}")
            return
        h.update(path.encode())
        h.update(np.ascontiguousarray(np.asarray(node)).tobytes())

    walk(tree, "")
    return h.hexdigest()


def tp_placement(trainer, state) -> dict:
    """Where a state's split tensors lie on this rank: the shapes of each
    module's ``feat_spe`` and ``classifier`` weights and their Adam
    moments, of the queues' features, whether ``assert_tp_placed`` holds,
    the digest of the rank's own tensors (its shards) and of the whole
    state (gathered: every rank calls this)."""
    from cmlpl_tpu_torch.core.mesh import assert_tp_placed, tp_of

    mods = (trainer._modules(state) if hasattr(trainer, "_modules")
            else {"model": state.model})
    opts = (trainer._opts(state) if hasattr(trainer, "_opts")
            else (state.opt,))
    shapes = {}
    for name, mod in mods.items():
        for n, p in mod.named_parameters():
            if n.endswith(("feat_spe.weight", "classifier.weight")):
                moments = [tuple(o.state[p]["exp_avg"].shape) for o in opts
                           if p in o.state]
                shapes[f"{name}.{n}"] = [tuple(p.shape)] + moments
    carry = trainer._carry(state) if hasattr(trainer, "_carry") else {}
    for name, c in carry.items():
        if name.startswith("queue"):
            shapes[f"{name}.feats"] = [tuple(c.feats.shape)]
    placed = True
    for mod in mods.values():
        tp = tp_of(mod)
        if tp is None:
            placed = False
            continue
        assert_tp_placed(mod, tp)
    local = (state_digest(trainer, state) if hasattr(trainer, "_modules")
             else zoo_digest(state))
    return {"shapes": shapes, "placed": placed, "local_digest": local,
            "whole_digest": tree_digest(trainer.state_to_jax(state))}


def run_tp_shared_card_rank(tmp) -> dict:
    """One of four gloo ranks on ``cuda:0`` as a ("data", "model") mesh of
    2 x 2 (``create_mesh_2d(tp=2)``; torchrun's environment set by
    :func:`start_tp_shared_card`), through the library: one noise-off step
    of CMLPL (f32, bf16 and with the memory bank), CPS and CCT at PaviaU
    width and of the supervised trainer on BaseNet2, BaseNet2Zoo, BaseNet1
    and SSRN at their own, each from one state (rank 0 also takes the
    one-rank step) with its placement; a 1-epoch f32 CMLPL run (78 steps,
    one pool) with the model axis's all-reduces counted and the data
    axis's timed; net B's map of its gathered weights over the data ranks
    (203 tiles a rank; rank 0 also maps the whole scene on one rank) and
    its dense map in strips of scene rows."""
    import torch.distributed as dist

    from cmlpl_tpu_torch.cli._common import logits_fn
    from cmlpl_tpu_torch.core.mesh import (TP_COLLECTIVES, create_mesh_2d,
                                           initialize_multihost)
    from cmlpl_tpu_torch.data.io import synthetic_scene
    from cmlpl_tpu_torch.data.pipeline import SemiSupervisedSampler
    from cmlpl_tpu_torch.data.prep import prepare_scene
    from cmlpl_tpu_torch.data.splits import generate_splits
    from cmlpl_tpu_torch.eval.inference import (ScenePredictor,
                                                dense_scene_logits)
    from cmlpl_tpu_torch.eval.metrics import cal_accuracy
    from cmlpl_tpu_torch.models.basenet import BaseNet2
    from cmlpl_tpu_torch.ops.patch_gather import WRAPPERS
    from cmlpl_tpu_torch.registry import get_dataset
    from cmlpl_tpu_torch.train.supervised import schedule
    from cmlpl_tpu_torch.weights import state_dict_from_jax

    def launches():
        return [w.launches for w in WRAPPERS]

    def reset():
        for w in WRAPPERS:
            w.launches = 0

    device = torch.device("cuda:0")
    require(initialize_multihost(backend="gloo", device=device) == 4,
            "not a world of four")
    mesh = create_mesh_2d(TP, device)
    require((mesh.size, mesh.tp, mesh.data_size, mesh.backend)
            == (4, TP, 2, "gloo"), f"mesh {mesh}")
    out = {"rank": mesh.rank, "coords": [mesh.data, mesh.model],
           "steps": {}, "placement": {}, "step_launches": {}}
    cube, gt = synthetic_scene(DATA_ID)
    tscene = prepare_scene(DATA_ID, cube=cube, gt=gt, patch_size=W,
                           n_pc=N_PC, device=device)
    li, ly, ui = (a[0] for a in default_schedule(tscene.labels, 1))
    first = (li[0], ly[0], ui[0])
    off = dict(noise=0.0, dropout=0.0, gather_impl="pool")
    for case, (algo, extra) in TP_STEPS.items():
        cfg = dict(off, **extra)
        trainer = mh_trainer(algo, mesh, **cfg)
        reset()
        two, state = mh_step(trainer, tscene, first, with_state=True)
        out["step_launches"][case] = launches()
        out["placement"][case] = tp_placement(trainer, state)
        if mesh.rank == 0:
            out["steps"][case] = hold_step(
                f"{case}: a 2 x 2 mesh vs one rank on the card", two,
                mh_step(mh_trainer(algo, **cfg), tscene, first),
                bf16="compute_dtype" in extra)
    # BaseNet2 and BaseNet2Zoo at PaviaU width take the training scene
    scenes = dict(zoo_mh_scenes(cube, gt, device, ("basenet1", "ssrn")),
                  basenet2=tscene, basenet2_zoo=tscene)
    labels = gt.reshape(-1).astype(np.int32)
    train = generate_splits(labels, num_label=5).train
    zli, zly = schedule(train, labels, ZOO_BATCH, 1, None, 1088,
                        data=mesh.data_size)
    out["zoo_batch"] = int(zli.shape[1])
    for name in TP_ZOO:
        two, (trainer, state) = zoo_mh_step(name, scenes[name], zli[0],
                                            zly[0], mesh, with_state=True)
        out["placement"][name] = tp_placement(trainer, state)
        if mesh.rank == 0:
            out["steps"][name] = hold_zoo_step(
                name, two, zoo_mh_step(name, scenes[name], zli[0], zly[0]))

    # a full-width f32 CMLPL epoch (78 steps, one pool) through fit
    trainer = mh_trainer("cmlpl", mesh, num_epochs=1)
    state = trainer.init_state(SEED)
    sampler = SemiSupervisedSampler(generate_splits(tscene.labels,
                                                    num_label=5),
                                    tscene.labels, 128, 128, 10000,
                                    seed=1088)
    reset()
    TP_COLLECTIVES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, history = trainer.fit(state, tscene, sampler, log_every=0)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["steps_run"] = len(history)
    out["train_launches"] = launches()
    out["tp_collectives"] = {"calls": TP_COLLECTIVES.calls,
                             "bytes": TP_COLLECTIVES.bytes,
                             "host_s": TP_COLLECTIVES.seconds}
    out["oa_history_acc_last"] = history[-1]["acc"]
    numel = sum(p.numel() for p in trainer.named_params(state).values())
    out["data_all_reduce"] = {
        "bytes": numel * 4,
        "ms": timed_all_reduce_ms(numel, device, group=mesh.data_group)}
    out["run_placement"] = tp_placement(trainer, state)
    # net B's map from its weights gathered whole: strips over the data
    # ranks, a model rank repeating its data rank's
    params = trainer.state_to_jax(state)["net_b"]["params"]
    model = BaseNet2(num_features=get_dataset(DATA_ID).num_bands,
                     num_classes=get_dataset(DATA_ID).num_classes,
                     n_pc=N_PC, patch_size=W)
    model.load_state_dict(state_dict_from_jax(params))
    model = model.to(device).eval()
    predictor = ScenePredictor(logits_fn(model), patch_size=W,
                               cols=tscene.cols, tile=TILE, gather="pallas",
                               mesh=mesh)
    reset()
    labels_map = predictor(tscene)
    out["map_launches"] = launches()
    splits = generate_splits(tscene.labels, num_label=5)
    out["oa_net_b"] = cal_accuracy(labels_map[splits.test],
                                   tscene.labels[splits.test] - 1).oa
    out["labels_digest"] = hashlib.sha256(labels_map.tobytes()).hexdigest()
    reset()
    dense = ScenePredictor(None, patch_size=W, cols=tscene.cols,
                           gather="dense", params=model.state_dict(),
                           mesh=mesh)(tscene)
    out["dense_launches"] = launches()
    out["dense_digest"] = hashlib.sha256(dense.tobytes()).hexdigest()
    if mesh.rank == 0:
        one = ScenePredictor(logits_fn(model), patch_size=W,
                             cols=tscene.cols, tile=TILE,
                             gather="pallas")(tscene)
        out["map_equals_one_rank_map"] = bool(np.array_equal(labels_map,
                                                             one))
        whole = ScenePredictor(None, patch_size=W, cols=tscene.cols,
                               gather="dense",
                               params=model.state_dict())(tscene)
        with torch.inference_mode():
            logits = dense_scene_logits(model.state_dict(), tscene)
        tie_safe_equal(dense, whole, lambda ids: logits[torch.from_numpy(
            ids).to(device)], "2 x 2 dense strips vs the one-rank dense map")
        out["dense_differing_pixels"] = int((dense != whole).sum())
    out["wall_s"] = time.perf_counter() - T_IMPORT
    dist.destroy_process_group()
    return out


def start_tp_shared_card(tmp):
    """The four ranks of :func:`run_tp_shared_card_rank`, started now, at
    a priority below the bundles' compiling children (their work has the
    A/B phases' minutes to finish in)."""
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": "4", "LOCAL_RANK": "0"}
    return [start_child(os.path.join(tmp, f"rank{r}"),
                        "run_tp_shared_card_rank", os.path.join(tmp, "files"),
                        nice=15, env=dict(env, RANK=str(r)))
            for r in range(4)]


def phase_tp_shared_card(children) -> dict:
    """Four gloo ranks on one card as a 2 x 2 mesh (``tp_shared_card``):
    every hold of :func:`run_tp_shared_card_rank`; returns the launches a
    rank."""
    ranks = [finish_child(c) for c in children]
    half = 1024 // TP
    for r in ranks:
        rank = r["rank"]
        require(r["coords"] == [rank // TP, rank % TP],
                f"rank {rank} at {r['coords']}")
        for case, pl in r["placement"].items():
            replicated = case == "ssrn"
            require(pl["placed"] is not replicated,
                    f"rank {rank} {case}: placed {pl['placed']}")
            for name, shapes in pl["shapes"].items():
                shapes = [tuple(sh) for sh in shapes]
                if name.endswith("feat_spe.weight"):
                    require(all(sh[0] == half for sh in shapes),
                            f"rank {rank} {case}: {name} {shapes}")
                elif name.endswith("classifier.weight"):
                    require(all(sh[1] in (2624 // TP, 256 // TP)
                                for sh in shapes),
                            f"rank {rank} {case}: {name} {shapes}")
                else:
                    require(shapes == [(1280, half)],
                            f"rank {rank} {case}: {name} {shapes}")
            require(replicated or pl["shapes"],
                    f"rank {rank} {case}: no split tensor")
        for case, n in r["step_launches"].items():
            want = [0, 1] if case == "cmlpl_bf16" else [1, 0]
            require(n == want, f"rank {rank} {case}: step launches {n}")
        require(r["steps_run"] == 78, f"steps {r['steps_run']}")
        require(r["train_launches"] == [1, 0],
                f"rank {rank}: 1-epoch run launches {r['train_launches']}")
        require(r["map_launches"] == [203, 0],
                f"rank {rank}: map launches {r['map_launches']}")
        require(r["dense_launches"] == [0, 0],
                f"rank {rank}: dense launches {r['dense_launches']}")
        require(r["tp_collectives"]["calls"] > 0,
                f"rank {rank}: no model-axis collective")
        require(r["zoo_batch"] == 44, f"zoo batch {r['zoo_batch']}")
    # the replicated tensors and same-index shards bitwise equal across
    # the data ranks; the model ranks of a data rank hold other blocks
    for case in ranks[0]["placement"]:
        pls = [r["placement"][case] for r in ranks]
        require(len({p["whole_digest"] for p in pls}) == 1,
                f"{case}: the whole states differ across ranks")
        require(pls[0]["local_digest"] == pls[2]["local_digest"]
                and pls[1]["local_digest"] == pls[3]["local_digest"],
                f"{case}: same-index shards differ across the data ranks")
        differ = pls[0]["local_digest"] != pls[1]["local_digest"]
        require(differ is (case != "ssrn"),
                f"{case}: model ranks' shards differ: {differ}")
    for key in ("labels_digest", "dense_digest", "oa_net_b"):
        require(len({r[key] for r in ranks}) == 1,
                f"the ranks differ in {key}")
    r0 = ranks[0]
    require(set(r0["steps"]) == set(TP_STEPS) | set(TP_ZOO),
            f"steps held: {sorted(r0['steps'])}")
    require(r0["map_equals_one_rank_map"],
            "the 2 x 2 map is not bitwise the one-rank map")
    steps = r0["steps_run"]
    emit({"phase": "tp_shared_card", "ranks": 4, "mesh": [2, TP],
          "backend": "gloo", "device": "cuda:0 (all four ranks)",
          "one_step_vs_one_rank": r0["steps"],
          "placement": {case: {"shapes": p["shapes"],
                               "placed": p["placed"]}
                        for case, p in r0["placement"].items()},
          "placement_rank1": {case: p["shapes"]
                              for case, p in ranks[1]["placement"].items()},
          "shards_differ_between_model_ranks": True,
          "replicas_and_same_index_shards_bitwise_equal": True,
          "epochs": 1, "steps": steps,
          "train_s": [r["train_s"] for r in ranks],
          "ms_per_step": [r["train_s"] / steps * 1e3 for r in ranks],
          "ms_per_step_note": "four ranks share one card: not a speed "
                              "figure",
          "tp_collectives_per_step": [
              {"calls": r["tp_collectives"]["calls"] / steps,
               "bytes": r["tp_collectives"]["bytes"] / steps,
               "host_ms": r["tp_collectives"]["host_s"] / steps * 1e3}
              for r in ranks],
          "data_all_reduce_per_step": [dict(r["data_all_reduce"], calls=1)
                                       for r in ranks],
          "rank_wall_s": [r["wall_s"] for r in ranks],
          "launches_per_rank": [{"pool": r["train_launches"][0],
                                 "map": r["map_launches"][0],
                                 "bf16_pool": r["step_launches"][
                                     "cmlpl_bf16"][1]} for r in ranks],
          "map_equals_one_rank_map": True, "oa_net_b": r0["oa_net_b"],
          "dense_map": {"launches": r0["dense_launches"],
                        "differing_pixels_vs_one_rank":
                        r0["dense_differing_pixels"]}})
    return {"train": r0["train_launches"][0], "map": r0["map_launches"][0],
            "bf16": r0["step_launches"]["cmlpl_bf16"][1]}


def phase_multihost_world1(tmp, cube, tscene, counter_fn) -> dict:
    """``cli.train --multihost`` as a one-rank NCCL world (torchrun's
    environment), 2 epochs of the default f32 cell, beside the same run
    with no process group: the OA within 1.0 point, one pool launch and
    406 map launches, ``ms_per_step`` of each; one step over the world
    against the step without it (step-1 gradients); a step's all-reduce
    and the draws every rank duplicates; ``serve --multihost`` of random
    weights on :func:`serve_requests` beside ``serve`` with no group (the
    labels bitwise, 406 launches each, ``latency_s`` and the scene
    broadcast of each).  The group is destroyed after."""
    import torch.distributed as dist

    from cmlpl_tpu_torch.cli import train as cli_train
    from cmlpl_tpu_torch.core.mesh import create_mesh

    from cmlpl_tpu_torch.core.mesh import all_reduce_sum

    maps = ("net B", "net E")
    (b0, e0), plain = train_cli_run(cli_train.main, os.path.join(tmp, "p"),
                                    "plain", counter_fn, maps, epochs=2)
    zoo_acc0, zoo_plain = zoo_cli_run(os.path.join(tmp, "zp"), counter_fn)
    serve_tmp = os.path.join(tmp, "serve")
    common, weights = serve_inputs(serve_tmp, cube, write=True)
    serve_argv = common + ["--weights", weights, "--no_warmup"]
    outs = {k: os.path.join(serve_tmp, k) for k in ("no_group", "world1")}
    for d in outs.values():
        os.makedirs(d)
    serve_plain = serve_run(serve_argv,
                            serve_requests(serve_tmp, outs["no_group"]))
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
           "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    os.environ.update(env)
    try:
        (b1, e1), world = train_cli_run(
            cli_train.main, os.path.join(tmp, "w"), "world1", counter_fn,
            maps, extra=["--multihost"], epochs=2)
        require(dist.is_initialized() and dist.get_backend() == "nccl"
                and dist.get_world_size() == 1,
                "cli.train --multihost did not start a one-rank NCCL world")
        all_reduce_sum.calls = all_reduce_sum.bytes = 0
        zoo_acc1, zoo_world = zoo_cli_run(os.path.join(tmp, "zw"),
                                          counter_fn, ["--multihost"])
        zoo_world["bn_all_reduces_per_step"] = (all_reduce_sum.calls
                                                / zoo_world["steps"])
        zoo_world["bn_all_reduce_bytes_per_step"] = (all_reduce_sum.bytes
                                                     / zoo_world["steps"])
        serve_world = serve_run(serve_argv + ["--multihost"],
                                serve_requests(serve_tmp, outs["world1"]))
        mesh = create_mesh()
        li, ly, ui = (a[0] for a in default_schedule(tscene.labels, 1))
        first = (li[0], ly[0], ui[0])
        off = dict(noise=0.0, dropout=0.0, gather_impl="pool")
        step = hold_step("world of one vs no group", mh_step(
            mh_trainer("cmlpl", mesh, **off), tscene, first),
            mh_step(mh_trainer("cmlpl", **off), tscene, first))
        trainer = mh_trainer("cmlpl", mesh)
        state = trainer.init_state(SEED)
        numel = sum(p.numel() for p in trainer.named_params(state).values())
        all_reduce = {"bytes": numel * 4,
                      "ms": timed_all_reduce_ms(numel, mesh.device)}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k)
    # the draws of a step over the whole batch, which every rank makes
    g = torch.Generator(tscene.device).manual_seed(SEED)
    xp = torch.randn(128, W, W, N_PC, device=tscene.device)
    x = torch.randn(128, tscene.spectra.shape[1], device=tscene.device)
    y = torch.zeros(128, dtype=torch.int64, device=tscene.device)
    draws_ms = cuda_ms(lambda: trainer._draws(g, xp, x, xp, x, y), [()] * 20)
    for rep in (plain, world):
        require(rep["launches_training"] == {"gather_patches_f32": 1,
                                             "gather_patches_bf16": 0},
                f"training launches {rep['launches_training']}")
        require(rep["launches_with_maps"] == {
            "gather_patches_f32": 1 + 2 * 406, "gather_patches_bf16": 0},
            f"launches with the maps {rep['launches_with_maps']}")
        require(all(n == {"gather_patches_f32": 406,
                          "gather_patches_bf16": 0}
                    for n in rep["launches_per_map"].values()),
                f"launches a map {rep['launches_per_map']}")
    for got, want, net in ((b1, b0, "B"), (e1, e0, "E"),
                           (zoo_acc1, zoo_acc0, MH_ZOO_MODEL)):
        require(abs(got.oa - want.oa) * 100 <= 1.0,
                f"net {net}: OA {got.oa} over a world of one, {want.oa} "
                "without")
    for rep in (zoo_plain, zoo_world):
        require(rep["launches_training"] == [ZOO_EPOCHS, 0]
                and rep["launches_map"] == [406, 0],
                f"train_backbone --model {MH_ZOO_MODEL} launches {rep}")
    require(zoo_world["bn_all_reduces_per_step"] > 0,
            "no BatchNorm all-reduce over the world of one")
    hold_serve("serve, no group", serve_plain, 0, [406, 0], True)
    hold_serve("serve --multihost, a world of one", serve_world, 1, [406, 0],
               True)
    require(np.array_equal(
        *(np.load(os.path.join(d, "good.npy")) for d in outs.values())),
        "serve --multihost in a world of one: the labels are not bitwise "
        "the labels with no group")
    emit({"phase": "multihost_world1", "backend": "nccl", "world": 1,
          "epochs": 2, "ms_per_step": world["ms_per_step"],
          "ms_per_step_no_group": plain["ms_per_step"],
          "train_s": world["train_s"], "train_s_no_group": plain["train_s"],
          "map_s": world["map_s"], "map_s_no_group": plain["map_s"],
          "oa": {"net_b": b1.oa, "net_e": e1.oa},
          "oa_no_group": {"net_b": b0.oa, "net_e": e0.oa},
          "one_step_vs_no_group": step, "all_reduce_per_step": all_reduce,
          "duplicated_draws_ms_per_step": draws_ms,
          "launches_training": world["launches_training"],
          "launches_per_map": world["launches_per_map"],
          "launches_per_map_no_group": plain["launches_per_map"]})
    emit({"phase": "multihost_world1_zoo", "backend": "nccl", "world": 1,
          "model": MH_ZOO_MODEL, "epochs": ZOO_EPOCHS, "world1": zoo_world,
          "no_group": zoo_plain})
    emit({"phase": "multihost_world1_serve", "backend": "nccl", "world": 1,
          "scene": "synthetic_scene(1), 610 x 340 x 103",
          "latency_s": serve_world["responses"][1]["latency_s"],
          "latency_s_no_group": serve_plain["responses"][1]["latency_s"],
          "scene_broadcast": {"calls": serve_world["broadcasts"]["calls"],
                              "bytes_per_call": SCENE_BYTES,
                              "ms_per_call":
                              serve_world["broadcasts"]["ms_per_call"]},
          "launches_per_response": serve_world["launches_per_line"],
          "launches_per_response_no_group":
          serve_plain["launches_per_line"],
          "wall_s": serve_world["wall_s"],
          "wall_s_no_group": serve_plain["wall_s"],
          "labels_equal_no_group": True})
    return {"train": world["launches_training"]["gather_patches_f32"],
            "map": world["launches_per_map"]["net B"]["gather_patches_f32"],
            "zoo_train": zoo_world["launches_training"][0],
            "zoo_map": zoo_world["launches_map"][0],
            "serve": serve_world["launches_per_line"][1]}


def watch_host_memory(low: list, stop: threading.Event) -> None:
    """Keeps in ``low`` (GiB, at_s) the least ``MemAvailable`` of the host
    seen every 2 s until ``stop``: the smoke runs up to four processes
    that trace and compile at once."""
    while not stop.wait(2.0):
        with open("/proc/meminfo") as f:
            avail = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("MemAvailable:"))
        if not low or avail / 2 ** 20 < low[0]:
            low[:] = [avail / 2 ** 20, time.perf_counter() - T_IMPORT]


def timed_build(build):
    """(path, seconds) of ``build()``."""
    t0 = time.perf_counter()
    path = build()
    return path, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cmlpl_tpu_torch.cli import predict, serve
    from cmlpl_tpu_torch.cli._common import logits_fn
    from cmlpl_tpu_torch.data.io import synthetic_scene
    from cmlpl_tpu_torch.data.patches import gather_patches
    from cmlpl_tpu_torch.data.prep import prepare_scene
    from cmlpl_tpu_torch.data.splits import generate_splits
    from cmlpl_tpu_torch.eval.inference import ScenePredictor
    from cmlpl_tpu_torch.eval.metrics import cal_accuracy
    from cmlpl_tpu_torch.models.basenet import BaseNet2
    from cmlpl_tpu_torch.ops import _build
    from cmlpl_tpu_torch.ops.column_sums import column_sums_seq
    from cmlpl_tpu_torch.ops.patch_gather import (WRAPPERS,
                                                  gather_patches_bf16,
                                                  gather_patches_f32)
    from cmlpl_tpu_torch.registry import get_dataset
    from cmlpl_tpu_torch.weights import (init_basenet2_params,
                                         save_params_npz,
                                         state_dict_from_jax)

    from cmlpl_tpu_torch.native.aoti_launcher import build_host

    t_start = time.perf_counter()
    device = torch.device("cuda")
    card = card_name_and_power()
    print(card, flush=True)
    flags_at_start = tf32_flags()
    # the export phase's native runner builds (g++, one core) while the
    # phases before it run
    host_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    host_build = host_pool.submit(timed_build, build_host)
    memory_low, stop_watch = [], threading.Event()
    threading.Thread(target=watch_host_memory, args=(memory_low, stop_watch),
                     daemon=True).start()

    # the training bundles' exports and AOTInductor compiles (minutes), and
    # the run program's checks that need no compiled bundle, run in two
    # processes of their own beside the phases before them; the export
    # phase's child starts beside the zoo
    child_tmp = tempfile.mkdtemp(prefix="smoke_children_")
    children = [start_child(os.path.join(child_tmp, "bundles"),
                            "run_train_bundle_child",
                            os.path.join(child_tmp, "bundles")),
                start_child(os.path.join(child_tmp, "checks"),
                            "run_bundle_checks_child"),
                start_child(os.path.join(child_tmp, "per_step"),
                            "run_per_step_bundle_child",
                            os.path.join(child_tmp, "per_step"))]

    def stop_children():
        for proc, _, _ in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(child_tmp, ignore_errors=True)

    atexit.register(stop_children)

    # 1. build
    t0 = time.perf_counter()
    lib_path, ptxas = _build.build()
    _build.library()
    emit({"phase": "build", "build_s": time.perf_counter() - t0,
          "library": os.path.relpath(lib_path, ROOT),
          "ptxas": [ln for ln in ptxas.splitlines() if "Used" in ln]})
    # the operators' C++ library (g++ against torch), after the runner
    op_build = host_pool.submit(timed_build, _build.op_library)

    def counter_fn():
        return (gather_patches_f32.launches, gather_patches_bf16.launches)

    spec = get_dataset(DATA_ID)
    params = init_basenet2_params(SEED, n_pc=N_PC,
                                  num_features=spec.num_bands,
                                  num_classes=spec.num_classes,
                                  patch_size=W)
    model = BaseNet2(num_features=spec.num_bands, dropout=0.8,
                     num_classes=spec.num_classes, n_pc=N_PC, patch_size=W)
    model.load_state_dict(state_dict_from_jax(params))
    model = model.to(device).eval()
    apply = logits_fn(model)
    cube, gt = synthetic_scene(DATA_ID)
    require(cube.shape == (610, 340, 103), f"scene shape {cube.shape}")
    scene = prepare_scene(DATA_ID, cube=cube, gt=np.zeros_like(gt),
                          patch_size=W, n_pc=N_PC, device=device)
    num_maps_tiles = -(-scene.num_pixels // TILE)
    require(num_maps_tiles == 406, f"{num_maps_tiles} tiles per map")

    # 2. kernels vs plain, times and bounds; their operators (Python here,
    # C++ in a process of its own that loads the runner's library)
    kernel_report = phase_kernels(scene, device)
    op_path, op_build_s = op_build.result()
    emit({"phase": "build_operators", "build_s": op_build_s,
          "library": os.path.relpath(op_path, ROOT)})
    cxx_child = start_child(
        os.path.join(child_tmp, "cxx_ops"), "run_cxx_operator_checks",
        op_path, map_tile_group(W, N_PC, 4), map_tile_group(W, N_PC, 2),
        nice=0)
    children.append(cxx_child)

    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "w.npz")
        save_params_npz(weights, params)
        scene_npy = os.path.join(tmp, "paviau.npy")
        np.save(scene_npy, cube)
        # an f32 crop, as a .npy of radiance comes: the card's prep of
        # each dtype runs on a request (the others are f64)
        crop = cube[:300, :200].astype(np.float32)
        crop_npy = os.path.join(tmp, "crop.npy")
        np.save(crop_npy, crop)
        common = ["--dataID", str(DATA_ID), "--n_PC", str(N_PC), "--w",
                  str(W), "--val_batch_size", str(TILE), "--weights",
                  weights, "--data_root", tmp]

        # 3. serve at full width (main path: the f32 gather)
        reqs = [{"id": "npy", "cube": scene_npy,
                 "out": os.path.join(tmp, "map.npy")},
                {"id": "svg", "cube": scene_npy,
                 "out": os.path.join(tmp, "map.svg")},
                {"id": "crop", "cube": crop_npy,
                 "out": os.path.join(tmp, "crop_map.npy")},
                {"id": "back", "cube": scene_npy,
                 "out": os.path.join(tmp, "map2.npy")}]
        stdin = io.StringIO("".join(json.dumps(r) + "\n" for r in reqs))
        stdout = ResponseLog(lambda: (gather_patches_f32.launches,
                                      column_sums_seq.launches))
        for wrapper in (*WRAPPERS, column_sums_seq):
            wrapper.launches = 0
        t0 = time.perf_counter()
        serve.main(common, stdin=stdin, stdout=stdout)
        serve_s = time.perf_counter() - t0
        serve_launches = {w.__name__: w.launches
                          for w in (*WRAPPERS, column_sums_seq)}
        lines = [json.loads(s) for s in stdout.getvalue().splitlines()]
        require(len(lines) == 1 + len(reqs), f"serve answered {lines}")
        require(lines[0].get("ready") is True, f"serve not ready: {lines[0]}")
        per_line = np.diff([(0, 0)] + stdout.counts, axis=0).T.tolist()
        per_request, sums_per_request = per_line
        for line in lines[1:]:
            require("error" not in line, f"serve error: {line}")
        crop_tiles = -(-300 * 200 // TILE)
        require(per_request == [406, 406, 406, crop_tiles, 406],
                f"f32 gather launches per map {per_request}")
        # the card's prep: 3 column-sum passes a scene; the warm-up
        # prepares an f32 and an f64 cube
        require(sums_per_request == [6, 3, 3, 3, 3],
                f"column_sums_seq launches per line {sums_per_request}")
        require(serve_launches["gather_patches_bf16"] == 0,
                "serve launched the bf16 gather")
        emit({"phase": "serve", "warmup_s": lines[0]["warmup_s"],
              "responses": lines[1:], "latency_s":
              [ln["latency_s"] for ln in lines[1:]],
              "f32_gather_launches_per_map": per_request,
              "column_sums_launches_per_line": sums_per_request,
              "launches": serve_launches, "wall_s": serve_s})

        served = np.load(reqs[0]["out"])
        require(served.shape == (scene.num_pixels,), "map shape")
        require(((served >= 0) & (served < spec.num_classes)).all(),
                "map classes out of range")
        require(np.array_equal(served, np.load(reqs[3]["out"])),
                "the same scene served twice gave two maps")
        with open(reqs[1]["out"], "rb") as f:
            require(f.read(4) == b"<svg", "svg map")
        # the served maps (kernel 1) against the plain gather's, on the
        # card's prep of their cubes and on the host's
        served_vs_host = {}
        for label, c, out in (("scene", cube, reqs[0]["out"]),
                              ("f32 crop", crop, reqs[2]["out"])):
            preps = {on_card: prepare_scene(
                DATA_ID, cube=c, gt=np.zeros(c.shape[:2], np.int64),
                patch_size=W, n_pc=N_PC, device=device, on_card=on_card)
                for on_card in (True, False)}
            plain = {on_card: ScenePredictor(
                apply, patch_size=W, cols=c.shape[1], tile=TILE,
                gather="xla")(sc) for on_card, sc in preps.items()}
            served_vs_host[label] = hold_served(
                np.load(out), plain[True], plain[False],
                tiled_logits(apply, preps[False]),
                f"served {label} (pallas) vs the plain gather's map")

        # a small input against the CPU reference (plain gather, f32)
        small_cube, small_gt = synthetic_scene(0)
        small = {d: prepare_scene(0, cube=small_cube, gt=small_gt,
                                  patch_size=W, n_pc=N_PC, device=d)
                 for d in ("cpu", "cuda")}
        cpu_model = BaseNet2(num_features=spec.num_bands,
                             num_classes=spec.num_classes, n_pc=N_PC,
                             patch_size=W)
        cpu_model.load_state_dict(state_dict_from_jax(params))
        cpu_apply = logits_fn(cpu_model.eval())
        card_small = ScenePredictor(apply, patch_size=W, cols=48, tile=TILE,
                                    gather="pallas")(small["cuda"])
        cpu_small = ScenePredictor(cpu_apply, patch_size=W, cols=48,
                                   tile=TILE, gather="xla")(small["cpu"])
        tie_safe_equal(card_small, cpu_small,
                       tiled_logits(cpu_apply, small["cpu"]),
                       "card vs CPU map")
        ids = torch.arange(TILE, dtype=torch.int32)
        with torch.inference_mode():
            xp = gather_patches(small["cpu"].padded_pca, ids, cols=48, w=W)
            x = small["cpu"].spectra[ids.long()]
            want = cpu_model(xp, x)
            got = model(xp.to(device), x.to(device))
        for g_, w_, nm in zip(got, want, ("logits", "feat")):
            require(torch.isfinite(g_).all(), f"{nm} not finite")
            require(torch.allclose(g_.cpu(), w_, rtol=1e-4, atol=1e-5),
                    f"{nm} card vs CPU: max diff "
                    f"{float((g_.cpu() - w_).abs().max())}")
        emit({"phase": "reference", "pallas_map_equals_plain_map": True,
              "served_vs_host_prep_differing_pixels": served_vs_host,
              "card_map_vs_cpu_map_differing_pixels":
              int((card_small != cpu_small).sum()),
              "logits_max_abs_diff_card_vs_cpu":
              float((got[0].cpu() - want[0]).abs().max())})

        # 4. predict with the bf16 gather (main path: the bf16 gather)
        for wrapper in WRAPPERS:
            wrapper.launches = 0
        t0 = time.perf_counter()
        pred = predict.main(common + ["--eval_gather", "pallas_bf16",
                                      "--out", os.path.join(tmp, "p.svg")])
        predict_s = time.perf_counter() - t0
        predict_launches = {w.__name__: w.launches for w in WRAPPERS}
        require(predict_launches == {"gather_patches_f32": 0,
                                     "gather_patches_bf16": 406},
                f"predict launches {predict_launches}")
        # predict read the registered .mat, absent: the synthetic PaviaU
        qscene = prepare_scene(DATA_ID, cube=cube, gt=gt, patch_size=W,
                               n_pc=N_PC, device=device)
        qscene.padded_pca = qscene.padded_pca.to(torch.bfloat16).float()
        qmap = ScenePredictor(apply, patch_size=W, cols=scene.cols,
                              tile=TILE, gather="xla")(qscene)
        require(np.array_equal(pred, qmap),
                "bf16 kernel map != plain bf16-quantised map")
        labels = qscene.labels
        splits = generate_splits(labels, num_label=5)
        acc = cal_accuracy(pred[splits.test], labels[splits.test] - 1)
        emit({"phase": "predict_bf16", "wall_s": predict_s,
              "launches": predict_launches,
              "map_equals_quantised_plain_map": True,
              "agreement_with_f32_map": float((pred == served).mean()),
              "oa": acc.oa, "aa": acc.aa, "kappa": acc.kappa,
              "note": "random weights on the synthetic PaviaU-size scene"})

    # where a map's time goes: gather vs forward+argmax, per map of 406
    tiles = map_tiles(scene.num_pixels, device)
    xp0 = gather_patches_f32(scene.padded_pca, tiles[0], cols=scene.cols,
                             w=W)
    x0 = scene.spectra.index_select(0, tiles[0])
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: torch.argmax(apply(xp0, x0), -1),
                         [()] * len(tiles), rounds=1)
    spectra_ms = cuda_ms(lambda t: scene.spectra.index_select(0, t),
                         [(t,) for t in tiles], rounds=1)
    predictor = ScenePredictor(apply, patch_size=W, cols=scene.cols,
                               tile=TILE, gather="pallas")
    predictor(scene)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predictor(scene)
    map_s = time.perf_counter() - t0
    dev_ms, counts, prof_wall_ms = profiled(predictor, [(scene,)])
    busy_ms = sum(dev_ms.values())
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:10]
    t0 = time.perf_counter()
    tscene = prepare_scene(DATA_ID, cube=cube, gt=gt, patch_size=W,
                           n_pc=N_PC, device=device)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prepare_scene(DATA_ID, cube=cube, gt=gt, patch_size=W, n_pc=N_PC,
                  device=device, on_card=True)
    torch.cuda.synchronize()
    prep_on_card_s = time.perf_counter() - t0
    emit({"phase": "breakdown", "map_s": map_s, "prep_s": prep_s,
          "prep_on_card_s": prep_on_card_s,
          "gather_f32_ms_per_map": kernel_report["patch_gather_f32"]["ms"]
          * len(tiles),
          "forward_argmax_ms_per_map": fwd_ms * len(tiles),
          "spectra_gather_ms_per_map": spectra_ms * len(tiles),
          "tiles": len(tiles),
          "profiled_map": {"wall_ms": prof_wall_ms,
                           "device_busy_ms": busy_ms,
                           "device_idle_share": 1 - busy_ms / prof_wall_ms,
                           "top_kernels_ms": [
                               {"name": k[:90], "ms": v, "calls": counts[k]}
                               for k, v in top]}})

    # dense whole-scene eval beside the tiled map
    phase_dense(params, cube, scene, served, map_s)

    # 5. training (slices 2 to 4): the kernels at the training shapes, the
    # steps of the three trainers on the card vs the CPU (f32, then bf16),
    # cli.train at full width with its default pool gather, one epoch with
    # each per-step kernel gather, cli.train_cps and cli.train_cct at full
    # width, the OA A/B of each CLI; bf16 training, a run with checkpoints,
    # a fault and a restart, and the extras
    phase_tf32_scope(device, flags_at_start)
    train_gather = phase_train_gather(tscene, tscene.labels, device)
    f32_grads = {algo: phase_card_vs_cpu(cube, gt, device, algo,
                                         flags_at_start)
                 for algo in ("cmlpl", "cps", "cct")}
    for algo in ("cmlpl", "cps", "cct"):
        phase_card_vs_cpu(cube, gt, device, algo, flags_at_start, "bfloat16",
                          f32_grads.pop(algo))

    with tempfile.TemporaryDirectory() as tmp:
        pool_launches = {}
        pool_launches["cmlpl"], eager_cmlpl = phase_train(tmp, cube, tscene,
                                                          counter_fn)
        per_step = phase_train_pallas(tmp, counter_fn)
        for algo in ("cps", "cct"):
            pool_launches[algo] = phase_train_algo(tmp, tscene, counter_fn,
                                                   algo)
        bf16_launches = phase_train_bf16(tmp, tscene, counter_fn)
        resume_launches = phase_resume(tmp, counter_fn, device)
        extras = phase_extras(tmp, tscene, counter_fn, device)
        # slice 7: prep, a profiled run served from its checkpoint, and
        # fused multi-seed runs, in a process of their own
        slice7 = slice7_in_child(os.path.join(tmp, "slice7"))
        prep, fused = slice7["prep"], slice7["fused"]
        # slice 12: two gloo ranks sharing the card, in processes of their
        # own beside the A/B phases, which time nothing they report
        shared = start_shared_card(os.path.join(child_tmp, "shared_card"))
        children.extend(shared)
        # slice 14: four gloo ranks as a 2 x 2 mesh on the card, beside
        tp_ranks = start_tp_shared_card(os.path.join(child_tmp, "tp_card"))
        children.extend(tp_ranks)
        ab, scene_npz = ab_inputs(tmp)
        for algo in ("cmlpl", "cps", "cct"):
            phase_ab(ab, scene_npz, algo)
        phase_ab(ab, scene_npz, "cmlpl", ["--compute_dtype", "bfloat16"],
                 "bf16_ab")
        shared_card = phase_multihost_shared_card(shared)
        tp_card = phase_tp_shared_card(tp_ranks)
    require(tf32_flags() == flags_at_start,
            f"TF32 left at {tf32_flags()}, found at {flags_at_start}")

    # 6. the comparison zoo (slice 5): kernel 1 at the zoo's shapes; then
    # 7. export (slice 8): the zip artifacts and the native runner's
    # bundles of the f32 xla, dense and bf16 maps, in a process of their
    # own started now, its exports and compiles beside the zoo's other
    # phases (each model's steps on the card vs the CPU,
    # cli.train_backbone for each, the OA A/B against the JAX package's
    # bank), its maps and timings after them
    zoo_kernels, zoo_floors = phase_zoo_kernels(device)
    _, host_build_s = host_build.result()
    host_pool.shutdown()
    torch.cuda.empty_cache()    # this process's cached blocks, for it
    export_gate = os.path.join(child_tmp, "export", "go")
    export_child = start_child(os.path.join(child_tmp, "export"),
                               "run_export",
                               os.path.join(child_tmp, "export", "run"),
                               host_build_s, export_gate, nice=0)
    children.append(export_child)
    zoo_launches = run_zoo(cube, gt, device, flags_at_start, counter_fn)
    open(export_gate, "w").close()     # the export's timings may start
    export = finish_child(export_child)

    # 8. the training-run bundles (slices 9 and 10): the 20-epoch CMLPL
    # run as one program, run by the runner and in Python, imported and
    # mapped; the 2-epoch memory-bank run by the runner, imported, mapped
    cxx_ops = finish_child(cxx_child)
    for name, err in cxx_ops["max_abs_err"].items():
        kernel_report[name]["max_abs_err"] = max(
            kernel_report[name]["max_abs_err"], err)
    child = {**finish_child(children[0]), **finish_child(children[1])}
    per_step_child = finish_child(children[2])
    with tempfile.TemporaryDirectory() as tmp:
        bundle_launches = phase_train_bundle(child, tmp, eager_cmlpl,
                                             extras["memobank"], counter_fn)
        # 9. the per-step bundle (slice 11): kernel 1 as its operator
        # inside the run program, run by the runner and in Python
        per_step_launches = phase_train_bundle_per_step(
            per_step_child, tmp, bundle_launches, per_step,
            child["per_step"], counter_fn)
    stop_children()
    # 10. multi-card data parallel (slice 12): cli.train --multihost as a
    # one-rank NCCL world beside the run with no process group
    with tempfile.TemporaryDirectory() as tmp:
        world1 = phase_multihost_world1(tmp, cube, tscene, counter_fn)
    # 11. kernel 3 at the prep's shape, in a process of its own, last
    sums_report = finish_child(start_child(
        os.path.join(child_tmp, "column_sums"), "run_column_sums_child",
        nice=0))

    launches = {"patch_gather_f32": serve_launches["gather_patches_f32"]
                + export["launches"],
                "patch_gather_bf16":
                predict_launches["gather_patches_bf16"]}
    launches_train = {
        "patch_gather_f32": {
            "cli.train default (pool), training": pool_launches["cmlpl"],
            "cli.train_cps default (pool), training": pool_launches["cps"],
            "cli.train_cct default (pool), training": pool_launches["cct"],
            "cli.train --gather_impl pallas, training":
            per_step["pallas"]["launches_training"][0],
            f"cli.train --checkpoint_every 1, {RESUME_EPOCHS} epochs and a "
            "restart (pool an epoch), training": resume_launches,
            "cli.train --profile_dir --checkpoint_dir --splits_dir, 2 epochs "
            "(pool), training": prep["train"],
            "cli.train --num_iters 4 --fused_iters, 2 epochs (one pool for "
            "the 4 seeds), training": fused["fused_f32"],
            "cli.train --num_iters 4 --fused_iters --extra_loss memobank, "
            "2 epochs (one pool for the 4 seeds), training":
            fused["fused_memobank"],
            "cli.predict --checkpoint_dir --net b, one map": prep["map"],
            "cli.predict --checkpoint_dir of the imported training-bundle "
            "run, one map": bundle_launches["predict"],
            "cli.predict --checkpoint_dir of the imported memobank "
            "training-bundle run, one map":
            bundle_launches["predict_memobank"],
            "cli.export_model --train_bundle --gather_impl pallas, 2 "
            "epochs: the compiled package in Python, its operator's "
            "launches": per_step_child["wrapper_launches"][
                "gather_patches_f32"],
            "cli.export_model --train_bundle --gather_impl pallas, 2 "
            "epochs: the compiled package in Python, kernel 1 on the card "
            "(profiler)": per_step_child["kernel_device_launches"],
            "cli.predict --checkpoint_dir of the imported per-step "
            "training-bundle run, one map": per_step_launches["predict"],
            "cli.train --multihost, a one-rank NCCL world, 2 epochs (pool), "
            "training": world1["train"],
            "cli.train --multihost, a one-rank NCCL world, one map":
            world1["map"],
            "two gloo ranks on one card, CMLPL 2 epochs (pool), training, "
            "each rank": shared_card["train"],
            "two gloo ranks on one card, net B's map, each rank's strip":
            shared_card["map"],
            "two gloo ranks on one card, CMLPL 3 steps, auto over the pool "
            "budget (kernel 1 a step), each rank": shared_card["over_budget"],
            "two gloo ranks on one card, one step of each zoo model with a "
            "BatchNorm (auto: kernel 1 a step), rank 0 (also the one-rank "
            "steps)": shared_card["zoo_steps"],
            f"two gloo ranks on one card, cli.train_backbone --multihost "
            f"--model {MH_ZOO_MODEL}, training, each rank":
            shared_card["zoo_train"],
            f"two gloo ranks on one card, cli.train_backbone --multihost "
            f"--model {MH_ZOO_MODEL}, its map's strip, each rank":
            shared_card["zoo_map"],
            f"cli.train_backbone --multihost --model {MH_ZOO_MODEL}, a "
            "one-rank NCCL world, training": world1["zoo_train"],
            f"cli.train_backbone --multihost --model {MH_ZOO_MODEL}, a "
            "one-rank NCCL world, one map": world1["zoo_map"],
            "a 2 x 2 mesh of four gloo ranks on one card, CMLPL 1 epoch "
            "(pool), training, each rank": tp_card["train"],
            "a 2 x 2 mesh of four gloo ranks on one card, net B's map of "
            "its gathered weights, each rank's strip": tp_card["map"],
            "two gloo ranks on one card, serve --multihost (auto), a "
            "request's map, each rank's strip": shared_card["serve"],
            "two gloo ranks on one card, predict --multihost "
            "--checkpoint_dir, each rank's strip": shared_card["predict"],
            "serve --multihost, a one-rank NCCL world, a request's map":
            world1["serve"]},
        "patch_gather_bf16": {
            "cli.train --gather_impl pallas_bf16, training":
            per_step["pallas_bf16"]["launches_training"][1],
            "cli.train --compute_dtype bfloat16 (pool), training":
            bf16_launches["cmlpl"],
            "cli.train_cps --compute_dtype bfloat16, 1 epoch, training":
            bf16_launches["cps"],
            "cli.train_cct --compute_dtype bfloat16, 1 epoch, training":
            bf16_launches["cct"],
            "cli.train --num_iters 4 --fused_iters --compute_dtype bfloat16, "
            "1 epoch (one pool for the 4 seeds), training":
            fused["fused_bf16"],
            "two gloo ranks on one card, one bf16 CMLPL step (pool), each "
            "rank": shared_card["bf16"],
            "a 2 x 2 mesh of four gloo ranks on one card, one bf16 CMLPL "
            "step (pool), each rank": tp_card["bf16"],
            "two gloo ranks on one card, serve --multihost --eval_gather "
            "pallas_bf16, a request's map, each rank's strip":
            shared_card["serve_bf16"]}}
    for name, n in zoo_launches.items():
        flags = " ".join(ZOO_EXTRA.get(name, []))
        launches_train["patch_gather_f32"][
            f"cli.train_backbone --model {name} {flags}".rstrip()
            + ", training (auto: kernel 1 a step)"] = n
    require(all(n > 0 for n in launches.values()),
            f"a kernel was not launched on the main path: {launches}")
    require(all(n > 0 for d in launches_train.values() for n in d.values()),
            f"a kernel was not launched on the training path: "
            f"{launches_train}")
    replaces = {"patch_gather_f32": "cmlpl_tpu/ops/patch_gather.py:95",
                "patch_gather_bf16": "cmlpl_tpu/ops/patch_gather.py:206"}
    kernels = []
    for name, rep in kernel_report.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": "cmlpl_tpu_torch/csrc/patch_gather.cu",
                        "replaces": replaces[name],
                        "launches": launches[name], **rep,
                        "floor_device_ms": zoo_floors[name]["device_ms"],
                        "floor": zoo_floors[name],
                        "floor_site": f"B=1 w={FLOOR_SITE[0]} "
                        f"C={FLOOR_SITE[1]}",
                        "launches_by_path": {
                            "serve": launches[name] - export["launches"],
                            "export --verify (auto)": export["launches"]}
                        if name == "patch_gather_f32" else
                        {"predict --eval_gather pallas_bf16": launches[name]},
                        "launches_train": launches_train[name],
                        "train_shapes": train_gather[name]
                        | fused["shapes"][name] | zoo_kernels[name]})
    # kernel 3 on serve's path: its warm-up prepares an f32 and an f64
    # cube (3 launches each), its requests the f64 scene but the f32 crop
    sums_launches = {"f32": 3 + sums_per_request[3],
                     "f64": 3 + sum(sums_per_request[i] for i in (1, 2, 4))}
    require(sum(sums_launches.values()) == serve_launches["column_sums_seq"],
            f"column_sums_seq launches {sums_launches}, "
            f"{serve_launches['column_sums_seq']} in all")
    for name, rep in sums_report.items():
        kernels.append({"name": f"column_sums_seq_{name}", "route": "cuda",
                        "source": "cmlpl_tpu_torch/csrc/column_sums.cu",
                        "replaces": "none: the JAX package prepares a scene "
                        "in host NumPy (cmlpl_tpu/data/prep.py)",
                        "launches": sums_launches[name], **rep,
                        "launches_by_path": {
                            "serve's warm-up": 3,
                            "serve, a request of this dtype": 3}})
    stop_watch.set()
    emit({"total_s": time.perf_counter() - t_start, "card": card,
          "host_mem_available_min_gib_at_s": memory_low})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
