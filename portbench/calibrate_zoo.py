"""``calibrate.py``'s readings for a zoo serving cell, with the zoo's own
planted faults (``faults_zoo.py``) beside calibrate's modes: one JSON
line a seed::

    python -m portbench.calibrate_zoo --workload serve-dbda-paviau \
        --mode no_cam --seeds 1 2 3 [--seconds 6]

Runs on the card, at the cell's own size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

MODES = ("sound", "control", "altered")


def main(argv=None) -> int:
    from portbench import calibrate, faults_zoo, registry
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True,
                   choices=MODES + faults_zoo.FAULTS)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate_zoo: no CUDA card", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.mode in MODES:
            got = calibrate.reading(cell, args.mode, seed, args.seconds, dev)
        else:
            with faults_zoo.planted(args.mode):
                got = calibrate.reading(cell, "sound", seed, args.seconds,
                                        dev)
        print(json.dumps({"cell": cell.name, "mode": args.mode, "seed": seed,
                          "s": round(time.perf_counter() - t0, 2), **got}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
