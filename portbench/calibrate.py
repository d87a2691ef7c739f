"""Readings of a cell's compared numbers, from which its limits are set:
the program as it runs (``sound``), the plain reference in TF32 judged
against itself in float32 (``control``), or the program with a planted
fault (``unchanged``, ``half``, ``altered``; ``faults.py``).  One JSON
line a seed; the training cells need no window, the serving cell a
short one::

    python -m portbench.calibrate --workload cmlpl-fused12-paviau \
        --mode sound --seeds 1 2 3 [--seconds 6]

Runs on the card, at the cell's own size.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def reading(cell, mode: str, seed: int, seconds: float, device) -> dict:
    """The compared numbers of one seed in ``mode``."""
    from portbench import faults, registry
    drv = registry.driver(cell.traffic["driver"]).Driver(cell, seed, device)
    if mode == "control":
        drv.inputs()
        return drv.control()
    ctx = (contextlib.nullcontext() if mode == "sound" else
           faults.planted(mode, cell.config["classes"]))
    with ctx:
        drv.setup()
        if seconds > 0:
            drv.window(seconds, None)
        drv.release()
        return drv.check()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True,
                   choices=("sound", "control", "unchanged", "half",
                            "altered"))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0,
                   help="window a seed (0: none; the serving cell needs "
                        "one)")
    args = p.parse_args(argv)
    import torch

    from portbench import registry
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = reading(cell, args.mode, seed, args.seconds, dev)
        print(json.dumps({"cell": cell.name, "mode": args.mode, "seed": seed,
                          "s": round(time.perf_counter() - t0, 2), **got}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
