#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cmlpl_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``cmlpl_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card and times both, then drives
the serving path at full width: BaseNet2 at PaviaU size (610x340x103
scene, n_PC 60, w 20, 9 classes, tiles of 512), random weights from a
seed.  ``cli.serve`` answers four JSON requests after its warm-up and
``cli.predict`` maps the scene with the bf16 gather.  Every phase prints
one JSON line; the card's name and power limit, then a ``kernels`` line
(launches on the main path, error, times and bounds) come before the last
line, ``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero without that line; so it does without CUDA.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
DATA_ID, N_PC, W, TILE = 1, 60, 20, 512     # PaviaU width
HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
TIMING_ROUNDS = 3                           # passes over a map's tiles


class CheckFailed(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    """One pass of ``fn(*args)`` over ``args_list`` under the profiler:
    returns (device ms per kernel name, launches per kernel name, wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def kernel_device_ms(fn, args_list, needle: str):
    """Device ms per launch of the kernels whose name holds ``needle``, from
    the profiler, or None when the profiler saw no device time."""
    dev_ms, counts, _ = profiled(fn, args_list)
    keys = [k for k in dev_ms if needle in k]
    n = sum(counts[k] for k in keys)
    return sum(dev_ms[k] for k in keys) / n if n else None


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def map_tiles(num_pixels: int, device) -> list[torch.Tensor]:
    """The main path's tiles: ids 0..K-1 in tiles of TILE, the last one
    padded with pixel 0 (ScenePredictor's decomposition)."""
    padded_k = -(-num_pixels // TILE) * TILE
    idx = np.arange(padded_k, dtype=np.int32)
    idx[num_pixels:] = 0
    return list(torch.from_numpy(idx).to(device).split(TILE))


def phase_kernels(scene, device):
    """Both kernels vs the plain gather, bitwise, at the serving shape and
    at odd w 9, w 8 and a ragged batch of 21 with ids off the scene; then
    their times over one map's tiles beside the plain version's, one
    PyTorch library call's and the bound."""
    from cmlpl_tpu_torch.data.patches import clamped_starts, gather_patches
    from cmlpl_tpu_torch.ops.patch_gather import (gather_patches_bf16,
                                                  gather_patches_f32)

    rows, cols = scene.rows, scene.cols
    g = torch.Generator(device=device).manual_seed(SEED)
    cases = []   # (label, cube f32, idx, cols, w)
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
        elt = cube.element_size()
        rc = [clamped_starts(t, cols, cube.shape[0], cube.shape[1], W)
              for t in tiles]
        # library yardstick: every window as a view, one advanced index per
        # tile; (B, C, w, w) viewed as (B, w, w, C)
        windows = cube.unfold(0, W, 1).unfold(1, W, 1)

        def library(r, c):
            return windows[r, c].permute(0, 2, 3, 1)

        require(torch.equal(library(*rc[0]), gather_patches(
            cube, tiles[0], cols=cols, w=W)), f"{name}: library call differs")
        ms = cuda_ms(lambda t: wrapper(cube, t, cols=cols, w=W),
                     [(t,) for t in tiles])
        plain_ms = cuda_ms(lambda t: gather_patches(cube, t, cols=cols, w=W),
                           [(t,) for t in tiles])
        library_ms = cuda_ms(library, rc)
        device_ms = kernel_device_ms(
            lambda t: wrapper(cube, t, cols=cols, w=W), [(t,) for t in tiles],
            "patch_gather_kernel")
        # bytes the function must move per tile: each output written once,
        # the ids and each cube pixel that this tile's windows touch read once
        touched = 0
        for r, c in rc:
            mask = torch.zeros(cube.shape[:2], dtype=torch.bool,
                               device=device)
            off = torch.arange(W, device=device)
            mask[(r[:, None] + off)[:, :, None],
                 (c[:, None] + off)[:, None, :]] = True
            touched += int(mask.sum())
        out_bytes = TILE * W * W * N_PC * elt
        in_bytes = touched / len(tiles) * N_PC * elt + TILE * 4
        bound_ms = (out_bytes + in_bytes) / HBM_BYTES_PER_S * 1e3
        report[name] = {"max_abs_err": max_err, "ms": ms, "kernel_ms": ms,
                        "device_ms": device_ms,
                        "plain_ms": plain_ms, "library_ms": library_ms,
                        "bound_ms": bound_ms, "bound_by": "bytes",
                        "bytes_per_launch": out_bytes + in_bytes,
                        "tiles_timed": len(tiles)}
        emit({"phase": "kernel_timing", "kernel": name, **report[name]})
    return report


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


def tie_safe_equal(got, want, logits_fn_, scene, what: str) -> None:
    """Maps from two devices may differ only where the two best logits lie
    within 1e-5 (f32 sums in another order can swap them)."""
    from cmlpl_tpu_torch.data.patches import gather_patches, gather_spectra

    diff = np.nonzero(got != want)[0]
    if diff.size:
        idx = torch.from_numpy(diff.astype(np.int32)).to(scene.device)
        with torch.inference_mode():
            logits = logits_fn_(
                gather_patches(scene.padded_pca, idx, cols=scene.cols, w=W),
                gather_spectra(scene.spectra, idx))
        top2 = logits.topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        require((gaps < 1e-5).all(),
                f"{what}: {diff.size} pixels differ, gaps {gaps[:8]}")


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
    from cmlpl_tpu_torch.ops.patch_gather import (WRAPPERS,
                                                  gather_patches_bf16,
                                                  gather_patches_f32)
    from cmlpl_tpu_torch.registry import get_dataset
    from cmlpl_tpu_torch.weights import (basenet2_state_dict_from_jax,
                                         init_basenet2_params,
                                         save_params_npz)

    t_start = time.perf_counter()
    device = torch.device("cuda")
    card = card_name_and_power()
    print(card, flush=True)

    # 1. build
    t0 = time.perf_counter()
    lib_path, ptxas = _build.build()
    _build.library()
    emit({"phase": "build", "build_s": time.perf_counter() - t0,
          "library": os.path.relpath(lib_path, ROOT),
          "ptxas": [ln for ln in ptxas.splitlines() if "Used" in ln]})

    spec = get_dataset(DATA_ID)
    params = init_basenet2_params(SEED, n_pc=N_PC,
                                  num_features=spec.num_bands,
                                  num_classes=spec.num_classes,
                                  patch_size=W)
    model = BaseNet2(num_features=spec.num_bands, dropout=0.8,
                     num_classes=spec.num_classes, n_pc=N_PC, patch_size=W)
    model.load_state_dict(basenet2_state_dict_from_jax(params))
    model = model.to(device).eval()
    apply = logits_fn(model)
    cube, gt = synthetic_scene(DATA_ID)
    require(cube.shape == (610, 340, 103), f"scene shape {cube.shape}")
    scene = prepare_scene(DATA_ID, cube=cube, gt=np.zeros_like(gt),
                          patch_size=W, n_pc=N_PC, device=device)
    num_maps_tiles = -(-scene.num_pixels // TILE)
    require(num_maps_tiles == 406, f"{num_maps_tiles} tiles per map")

    # 2. kernels vs plain, times and bounds
    kernel_report = phase_kernels(scene, device)

    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "w.npz")
        save_params_npz(weights, params)
        scene_npy = os.path.join(tmp, "paviau.npy")
        np.save(scene_npy, cube)
        crop = cube[:300, :200]
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
        stdout = ResponseLog(lambda: gather_patches_f32.launches)
        for wrapper in WRAPPERS:
            wrapper.launches = 0
        t0 = time.perf_counter()
        serve.main(common, stdin=stdin, stdout=stdout)
        serve_s = time.perf_counter() - t0
        serve_launches = {w.__name__: w.launches for w in WRAPPERS}
        lines = [json.loads(s) for s in stdout.getvalue().splitlines()]
        require(len(lines) == 1 + len(reqs), f"serve answered {lines}")
        require(lines[0].get("ready") is True, f"serve not ready: {lines[0]}")
        per_request = np.diff([0] + stdout.counts).tolist()
        for line in lines[1:]:
            require("error" not in line, f"serve error: {line}")
        crop_tiles = -(-300 * 200 // TILE)
        require(per_request == [406, 406, 406, crop_tiles, 406],
                f"f32 gather launches per map {per_request}")
        require(serve_launches["gather_patches_bf16"] == 0,
                "serve launched the bf16 gather")
        emit({"phase": "serve", "warmup_s": lines[0]["warmup_s"],
              "responses": lines[1:], "latency_s":
              [ln["latency_s"] for ln in lines[1:]],
              "f32_gather_launches_per_map": per_request,
              "launches": serve_launches, "wall_s": serve_s})

        served = np.load(reqs[0]["out"])
        require(served.shape == (scene.num_pixels,), "map shape")
        require(((served >= 0) & (served < spec.num_classes)).all(),
                "map classes out of range")
        require(np.array_equal(served, np.load(reqs[3]["out"])),
                "the same scene served twice gave two maps")
        with open(reqs[1]["out"], "rb") as f:
            require(f.read(4) == b"<svg", "svg map")
        plain_map = ScenePredictor(apply, patch_size=W, cols=scene.cols,
                                   tile=TILE, gather="xla")(scene)
        require(np.array_equal(served, plain_map),
                "pallas map != plain-gather map on the card")
        crop_scene = prepare_scene(DATA_ID, cube=crop,
                                   gt=np.zeros(crop.shape[:2], np.int64),
                                   patch_size=W, n_pc=N_PC, device=device)
        crop_plain = ScenePredictor(apply, patch_size=W, cols=200, tile=TILE,
                                    gather="xla")(crop_scene)
        require(np.array_equal(np.load(reqs[2]["out"]), crop_plain),
                "cropped pallas map != plain-gather map")

        # a small input against the CPU reference (plain gather, f32)
        small_cube, small_gt = synthetic_scene(0)
        small = {d: prepare_scene(0, cube=small_cube, gt=small_gt,
                                  patch_size=W, n_pc=N_PC, device=d)
                 for d in ("cpu", "cuda")}
        cpu_model = BaseNet2(num_features=spec.num_bands,
                             num_classes=spec.num_classes, n_pc=N_PC,
                             patch_size=W)
        cpu_model.load_state_dict(basenet2_state_dict_from_jax(params))
        cpu_apply = logits_fn(cpu_model.eval())
        card_small = ScenePredictor(apply, patch_size=W, cols=48, tile=TILE,
                                    gather="pallas")(small["cuda"])
        cpu_small = ScenePredictor(cpu_apply, patch_size=W, cols=48,
                                   tile=TILE, gather="xla")(small["cpu"])
        tie_safe_equal(card_small, cpu_small, cpu_apply, small["cpu"],
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
    prepare_scene(DATA_ID, cube=cube, gt=gt, patch_size=W, n_pc=N_PC,
                  device=device)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    emit({"phase": "breakdown", "map_s": map_s, "prep_s": prep_s,
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

    launches = {"patch_gather_f32": serve_launches["gather_patches_f32"],
                "patch_gather_bf16":
                predict_launches["gather_patches_bf16"]}
    require(all(n > 0 for n in launches.values()),
            f"a kernel was not launched on the main path: {launches}")
    replaces = {"patch_gather_f32": "cmlpl_tpu/ops/patch_gather.py:95",
                "patch_gather_bf16": "cmlpl_tpu/ops/patch_gather.py:206"}
    kernels = []
    for name, rep in kernel_report.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": "cmlpl_tpu_torch/csrc/patch_gather.cu",
                        "replaces": replaces[name],
                        "launches": launches[name], **rep})
    emit({"total_s": time.perf_counter() - t_start, "card": card})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
