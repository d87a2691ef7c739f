"""One run of one cell: set-up, the measured window (traced or not), the
memory peak, the check against the plain reference, and the result.

A driver (``drivers/<name>.py``, named by the cell's traffic) has
``Driver(cell, seed, device)`` with ``setup()``, ``window(seconds,
profiled)`` (returns what the metric readers read: ``seconds``,
``attempted``, ``failed`` and its own keys), ``release()`` (frees the
program's state) and ``check()`` (the compared numbers by name, after
the window, in blocks that fit).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import torch

from portbench import counts, registry
from portbench.profile import Profiled

#: top-level module names that no run may hold once its window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cmlpl_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names in ``sys.modules``, compared whole
    (``cmlpl_tpu_torch`` is not ``cmlpl_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""
    cell: registry.Cell
    setup_s: float
    window: dict
    trace: object | None
    peaks: dict | None


def run(cell: registry.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> dict:
    """Runs ``cell`` once and returns the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown``
    when traced, ``checks``).  ``t_start``: the process's start on
    ``time.perf_counter``, from which set-up counts."""
    drv = registry.driver(cell.traffic["driver"]).Driver(cell, seed, device)
    try:
        return _measure(cell, drv, seconds, trace, device, t_start)
    finally:
        # a driver that writes files removes them, however the run ends
        getattr(drv, "close", lambda: None)()


def _measure(cell, drv, seconds: float, trace: bool, device: torch.device,
             t_start: float) -> dict:
    drv.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    if trace:
        with Profiled(device) as prof:
            win = drv.window(seconds, prof)
        tr = prof.trace
    else:
        win = drv.window(seconds, None)
        tr = None
    _sync(device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": cell.chips,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    limit = power_limit_w() if device.type == "cuda" else None
    if limit is not None:
        dev["power_limit_w"] = limit
    ctx = Context(cell, setup_s, win, tr, counts.peaks(kind))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = registry.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = drv.check()
    checks = {name: {"value": got.get(name, math.inf), "limit": lim}
              for name, lim in cell.limits.items()}
    correct = all(_within(c["value"], c["limit"]) for c in checks.values())
    out = {"correct": correct, "attempted": int(win["attempted"]),
           "failed": int(win["failed"]), "metrics": metrics, "device": dev}
    if tr is not None:
        out["breakdown"] = tr.breakdown()
    # for the record: the window's length and, serving, each request's
    # seconds
    out["window"] = {k: win[k] for k in ("seconds", "latencies")
                     if k in win}
    out["checks"] = checks
    return out


def _within(value, limit) -> bool:
    return isinstance(value, float) and math.isfinite(value) and \
        value <= limit


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit_w() -> float | None:
    """The card's power limit in W by ``nvidia-smi``, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
