"""Times the device prep of a scene on one card (``data/prep.py``).

    python scripts/prep_on_card.py [--repeats 5] [--out FILE]

Prints JSON lines, and appends them to ``--out`` when given:

- ``column_sums_seq``: the kernel on PaviaU's pixel matrix (207,400 x
  103), f32 and f64, plain sums and squared deviations: device us a launch
  from CUDA events around ``--launches`` launches; its bound, the larger
  of the chain of 207,400 dependent adds at 4 cycles each at the card's
  highest SM clock and the bytes over 3.35 TB/s; the cycles an add took;
  one ``torch.sum(x, 0)`` (the same sums, in another order); and the plain
  version once (f32 sums);
- ``prepare_scene``: a PaviaU-sized f32 cube prepared ``--repeats`` times
  by the host path (NumPy, then the upload of its results) and by the
  device path (the upload of the raw cube, then the card), in turns, each
  to a synchronise: the seconds of each, and from one profiled device prep
  its spans' seconds, its launches of the kernel, its device time by
  kernel and the device memory it took.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROWS, COLS, BANDS, CLASSES = 610, 340, 103, 9
PAVIAU, N_PC, W = 1, 60, 20
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
ADD_CYCLES = 4                   # latency of a dependent add, assumed


def _query(field: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def _emit(rec: dict, out: str | None) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def _event_us(fn, launches: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / launches


def kernel_times(device, launches: int, sm_hz: float, out) -> None:
    from cmlpl_tpu_torch.ops.column_sums import (column_sums_plain,
                                                 column_sums_seq)

    n = ROWS * COLS
    for dtype in (torch.float32, torch.float64):
        x = torch.from_numpy(np.random.default_rng(0).normal(
            1000.0, 100.0, (n, BANDS))).to(device, dtype)
        mid = x.mean(0)
        chain_us = n * ADD_CYCLES / sm_hz * 1e6
        bytes_us = x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e6
        rec = {"what": "column_sums_seq", "dtype": str(dtype), "rows": n,
               "cols": BANDS, "bound_us": max(chain_us, bytes_us),
               "chain_us": chain_us, "bytes_us": bytes_us}
        for name, fn in (("sums", lambda: column_sums_seq(x)),
                         ("squares", lambda: column_sums_seq(x, mid))):
            us = _event_us(fn, launches)
            rec[f"{name}_us"] = us
            rec[f"{name}_cycles_per_add"] = us * 1e-6 * sm_hz / n
        rec["library_us"] = _event_us(lambda: torch.sum(x, 0), launches)
        if dtype == torch.float32:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            column_sums_plain(x)
            torch.cuda.synchronize()
            rec["plain_us"] = (time.perf_counter() - t0) * 1e6
        _emit(rec, out)


def prep_times(device, repeats: int, out) -> None:
    from cmlpl_tpu_torch.data import prep
    from cmlpl_tpu_torch.ops.column_sums import column_sums_seq
    from cmlpl_tpu_torch.utils.profiling import take_spans
    from portbench import scenes

    cube, _ = scenes.make_scene(scenes.streams(7, 1)[0], ROWS, COLS, BANDS,
                                CLASSES, device)
    cube = cube.cpu().numpy()
    gt = np.zeros((ROWS, COLS), np.int64)

    def on_card():
        prep.prepare_scene(PAVIAU, cube=cube, gt=gt, patch_size=W,
                           n_pc=N_PC, device=device, on_card=True)

    def on_host():
        prep.prepare_scene(PAVIAU, cube=cube, gt=gt, patch_size=W,
                           n_pc=N_PC, device=device)

    times = {"host": [], "device": []}
    on_card()
    for _ in range(repeats):
        for name, fn in (("host", on_host), ("device", on_card)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)

    take_spans()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    # CUDA activity alone, as the benchmark traces
    acts = [torch.profiler.ProfilerActivity.CUDA]
    launches = column_sums_seq.launches
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(0.1)                  # CUPTI_SETTLE_S
        on_card()
        torch.cuda.synchronize()
    launches = column_sums_seq.launches - launches
    spans = {}
    for s in take_spans():
        spans[s.name] = spans.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
    kernels = sorted(((e.key, e.device_time_total) for e in
                      prof.key_averages() if e.device_time_total > 0),
                     key=lambda kv: -kv[1])
    _emit({"what": "prepare_scene", "repeats": repeats,
           "host_s": times["host"], "device_s": times["device"],
           "host_median_s": statistics.median(times["host"]),
           "device_median_s": statistics.median(times["device"]),
           "spans_s": spans, "kernel_launches": launches,
           "device_us_by_kernel": kernels[:16],
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device)
           - base}, out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--launches", type=int, default=20)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("prep_on_card: CUDA is not available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    sm_hz = float(_query("clocks.max.sm").split()[0]) * 1e6
    _emit({"card": _query("name,power.limit"), "sm_max_hz": sm_hz,
           "torch": torch.__version__}, args.out)
    kernel_times(device, args.launches, sm_hz, args.out)
    prep_times(device, args.repeats, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
