"""Finds a cell and everything that belongs to it by name.

``BENCHMARK.json`` (at the checkout's root) lists the cells, the
configurations' files and the metrics.  A cell's traffic mix is
``traffic/<traffic>.json``, whose ``driver`` names the general generator
``drivers/<driver>.py``; its correctness limits are
``workloads/<cell>.json``; each metric's reader is ``metrics/<name>.py``
with a ``read(ctx)`` that returns the value or None.  A later cell or
metric is added as files and entries, without an edit here.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import re

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def params(self) -> dict:
        """The configuration's numbers with the traffic's over them."""
        return {**self.config, **self.traffic}


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, bench: dict | None = None, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (default: the checkout's
    ``BENCHMARK.json``); raises KeyError for a name it does not list."""
    bench = load_benchmark(root) if bench is None else bench
    check_name(name)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]]
    if not conf:
        raise KeyError(f"cell {name!r} names no listed config")
    config = _json(root, conf[0]["file"])
    traffic = _json(PKG, "traffic", check_name(w["traffic"]) + ".json")
    limits = _json(PKG, "workloads", name + ".json")["limits"]
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def driver(name: str):
    """The traffic generator module ``drivers/<name>.py``."""
    if not re.match(r"^[a-z_][a-z0-9_]*$", name):
        raise ValueError(f"not a driver name: {name!r}")
    return importlib.import_module(f"portbench.drivers.{name}")


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    path = os.path.join(PKG, "metrics", check_name(metric) + ".py")
    if not os.path.exists(path):
        raise KeyError(f"no reader for metric {metric!r}")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
