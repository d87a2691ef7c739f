"""How often a ``torch.profiler`` session on the card misses kernel
records, with and without ``utils/profiling.CUPTI_SETTLE_S`` of wait
between the profiler's start and the work.

    python -m cmlpl_tpu_torch.utils.profiler_check --seconds 90

Sessions alternate between the two modes ("now": the work starts as the
profiler does; "settled": after the wait).  A session's work is
``--launches`` kernel-1 gathers of PaviaU map tiles (padded cube
(630, 360, 60) f32, 512 ids), each followed by a small matmul.  Prints one
JSON line: per mode the sessions, those whose profiler count of the
gather fell short of the wrapper's, and the records missed in all; and
the card's name and power limit (``nvidia-smi``).  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from cmlpl_tpu_torch.ops.patch_gather import gather_patches_f32
from cmlpl_tpu_torch.utils.profiling import CUPTI_SETTLE_S


def session(cube, ids, weights, launches: int, settle: float) -> int:
    """Records of the gather the profiler missed in one session."""
    from torch.profiler import ProfilerActivity, profile

    before = gather_patches_f32.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(settle)
        for i in range(launches):
            x = gather_patches_f32(cube, ids[i % len(ids)], cols=340, w=20)
            (x.reshape(x.shape[0], -1) @ weights).argmax(-1)
        torch.cuda.synchronize()
    seen = sum(e.count for e in prof.key_averages()
               if "patch_gather_" in e.key)
    return gather_patches_f32.launches - before - seen


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seconds", type=float, default=90.0)
    p.add_argument("--launches", type=int, default=60)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profiler_check traces the card: no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cube = torch.randn(630, 360, 60, device=dev, generator=gen)
    weights = torch.randn(20 * 20 * 60, 64, device=dev, generator=gen)
    ids = [torch.randint(0, 610 * 340, (512,), device=dev, generator=gen,
                         dtype=torch.int32) for _ in range(8)]
    session(cube, ids, weights, 8, CUPTI_SETTLE_S)  # build, load, warm up
    modes = {"now": 0.0, "settled": CUPTI_SETTLE_S}
    out = {m: {"sessions": 0, "short_sessions": 0, "missed_records": 0}
           for m in modes}
    end = time.time() + args.seconds
    while time.time() < end:
        for mode, settle in modes.items():
            missed = session(cube, ids, weights, args.launches, settle)
            out[mode]["sessions"] += 1
            out[mode]["short_sessions"] += missed > 0
            out[mode]["missed_records"] += missed
    out["settle_s"] = CUPTI_SETTLE_S
    out["launches_per_session"] = args.launches
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
