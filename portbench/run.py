"""Runs one cell of ``BENCHMARK.json`` once on the card and prints its
result as the last line of standard output::

    python -m portbench.run --workload serve-paviau --seed 7 \
        --seconds 40 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window.  Each number compared with the
plain reference is printed beside its limit on standard error, last, and
under ``checks``, the result line's last key.  Without a CUDA card, or
with fewer cards than the cell asks for, the run fails and prints no
result: nothing falls back to the CPU.  So does a run whose process
holds JAX or the JAX package once the window has closed.

Build and kernel caches go to fixed directories inside the checkout
(``.portbench_cache/``; the kernels' own library to
``cmlpl_tpu_torch/_build/``), so only a checkout's first run builds.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")


def _env() -> None:
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be >= 0")
    _env()
    import torch

    from portbench import harness, registry
    cell = registry.cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA card; the benchmark measures the card "
              "and runs nowhere else", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    held = harness.forbidden_modules()
    if held:
        print(f"portbench: the process holds {held} after the window",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    out["checks"] = {k: {"value": _number(c["value"]), "limit": c["limit"]}
                     for k, c in out["checks"].items()}
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
