"""The cells ``serve-dbda-paviau`` and ``serve-paviau-4card``: the
registry finds their files, each runs end to end on the CPU at a tiny
size (DBDA at 3 x 3 patches on 16 x 12 cubes; the four ranks as two gloo
ranks), a planted fault fails its check, a rank that exits ends the run
at once, and their new readers (``launches_per_tile.serve``,
``broadcast_ms.serve``, ``mfu.serve_dbda``) read synthetic traces."""

import dataclasses
import math
import os
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from portbench import faults, faults_zoo, harness, registry
from portbench.tests.test_portbench_spans import (  # noqa: F401
    T0, T1, _read, program)

CPU = torch.device("cpu")
SEED = 2 ** 31 + 2020
NEW = ("serve-dbda-paviau", "serve-paviau-4card")
TINY = {
    "serve-dbda-paviau": {
        "dataset_id": 0, "rows": 16, "cols": 12, "patch_size": 3,
        "serve_tile": 64, "cubes": 2, "checked_requests": 2},
    "serve-paviau-4card": {
        "dataset_id": 0, "rows": 64, "cols": 48, "n_pc": 8, "patch_size": 8,
        "serve_tile": 256, "cubes": 2, "checked_requests": 2},
}


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(name: str) -> registry.Cell:
    """The cell at the tiny size, on two ranks where it asks for four."""
    c = registry.cell(name)
    t = TINY[name]
    return dataclasses.replace(
        c, chips=min(c.chips, 2),
        config={**c.config, **{k: v for k, v in t.items() if k in c.config}},
        traffic={**c.traffic, **{k: v for k, v in t.items()
                                 if k not in c.config}})


def _run(name, trace=False):
    return harness.run(tiny(name), SEED, 0.5, trace, CPU, time.perf_counter())


@pytest.mark.parametrize("name", NEW)
def test_the_registry_finds_the_cells_files(name):
    cell = registry.cell(name)
    assert cell.chips == (4 if name.endswith("4card") else 1)
    registry.driver(cell.traffic["driver"])
    assert set(cell.limits) == {"label_gap", "failed_requests"}
    assert {m["name"] for m in cell.end_to_end} == {"serve_latency_s",
                                                    "setup_s"}
    for m in cell.per_layer:
        assert callable(registry.reader(m["name"]))
    layer = {m["name"] for m in cell.per_layer}
    assert "launches_per_tile.serve" in layer
    assert ("broadcast_ms.serve" in layer) == (cell.chips == 4)
    assert ("mfu.serve_dbda" in layer) == (cell.config["model"] == "dbda")
    # the counts of one card's whole BaseNet2 map read neither
    assert "mfu.serve" not in layer
    assert ("gather_roofline.serve" in layer) == (cell.chips == 1)


def test_the_dbda_configuration_is_the_published_model():
    c = registry.cell("serve-dbda-paviau").config
    assert (c["model"], c["patch_size"], c["n_pc"], c["bands"]) == (
        "dbda", 9, 103, 103)
    assert (c["rows"], c["cols"], c["serve_tile"]) == (610, 340, 512)
    from portbench.reference import dbda
    shapes = dbda.shapes(c["bands"], c["classes"])
    assert c["parameters"] == sum(math.prod(s) for k, s in shapes.items()
                                  if "running" not in k)


@pytest.mark.parametrize("name", NEW)
def test_sound_run_is_correct(name):
    out = _run(name, trace=name.endswith("4card"))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    if name.endswith("4card"):
        # rank 0's broadcast, read from its spans in this process
        assert out["metrics"]["broadcast_ms.serve"]["value"] > 0
    else:
        assert set(out["metrics"]) == {"serve_latency_s", "setup_s"}


@pytest.mark.parametrize("name,fault", [
    ("serve-dbda-paviau", "altered"),
    ("serve-paviau-4card", "altered"),
    *[("serve-dbda-paviau", f) for f in faults_zoo.FAULTS]])
def test_fault_is_caught(name, fault):
    ctx = (faults.planted(fault, 9) if fault == "altered"
           else faults_zoo.planted(fault))
    with ctx:
        out = _run(name)
    assert not out["correct"], out["checks"]


def test_a_rank_that_exits_ends_the_run_at_once(tmp_path):
    """A child rank that exits non-zero before rank 0 is ready: the run
    ends in seconds with exit code 1 and the child's last lines."""
    script = textwrap.dedent(f"""
        import subprocess, sys, time, torch
        from portbench.drivers import serve_ranks
        from portbench.tests.test_portbench_zoo_cells import tiny
        from portbench import harness
        orig = subprocess.Popen
        def dies(cmd, **kw):
            return orig([sys.executable, "-c", "import sys, time; "
                         "time.sleep(1); print('rank gone', file=sys.stderr);"
                         " sys.exit(3)"], **kw)
        serve_ranks.subprocess.Popen = dies
        torch.set_num_threads(2)
        harness.run(tiny("serve-paviau-4card"), {SEED}, 0.5, False,
                    torch.device("cpu"), time.perf_counter())
        print("not reached")
    """)
    t0 = time.perf_counter()
    root = registry.ROOT
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=root, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2"))
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert time.perf_counter() - t0 < 90
    assert "rank 1 exited with 3" in proc.stderr
    assert "rank gone" in proc.stderr
    assert "not reached" not in proc.stdout


TILES = [("map.tile", T0 + 1000, T0 + 2000),
         ("map.tile", T0 + 3000, T0 + 4000),
         ("map.tile", T1 - 500, T1 + 500)]            # past the window


def test_launches_per_tile_takes_the_launches_inside_tiles(
        program):  # noqa: F811
    names = ["cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
             "cudaGraphLaunch"]
    inside = [(n, T0 + 1100 + 10 * k, T0 + 1105 + 10 * k)
              for k, n in enumerate(names)]
    inside += [("cudaLaunchKernel", T0 + 3100, T0 + 3150)]
    others = [("cudaMemcpyAsync", T0 + 3200, T0 + 3300),
              ("cudaLaunchKernel", T0 + 900, T0 + 1100),   # begun before
              ("cudaLaunchKernel", T0 + 2500, T0 + 2600),  # between tiles
              ("cudaLaunchKernel", T1 - 100, T1 - 50)]     # in the cut tile
    program(TILES)
    assert _read("launches_per_tile.serve", inside + others) == \
        pytest.approx(5 / 2)
    program(TILES)
    assert _read("launches_per_tile.serve",
                 [("aten::mm", T0 + 1100, T0 + 1200)]) is None
    program([])
    assert _read("launches_per_tile.serve", inside) is None


def test_broadcast_ms_reads_the_mean_broadcast_inside_the_window(
        program):  # noqa: F811
    spans = [("serve.broadcast", T0 + 100, T0 + 200_100),
             ("serve.broadcast", T0 + 300_000, T0 + 400_000),
             ("serve.broadcast", T1 - 100, T1 + 500),   # past the window
             ("serve.request", T0, T0 + 500_000)]
    program(spans)
    assert _read("broadcast_ms.serve") == pytest.approx(0.15)
    program(spans[2:])
    assert _read("broadcast_ms.serve") is None


def test_mfu_serve_dbda_is_the_least_map_work_over_the_requests_time():
    from portbench import counts_dbda
    cell = registry.cell("serve-dbda-paviau")
    peaks = {"flops_per_s": {"float32": 67e12}}
    trace = object()
    window = {"ok": 3, "latencies": [2.0, 2.0, 2.0, 4.0]}
    ctx = harness.Context(cell, 0.0, window, trace, peaks)
    want = 100 * 3 * counts_dbda.map_flops(cell.params) / 10.0 / 67e12
    assert registry.reader("mfu.serve_dbda")(ctx) == pytest.approx(want)
    assert 0.8 < want < 0.9
    ctx = harness.Context(cell, 0.0, window, None, peaks)
    assert registry.reader("mfu.serve_dbda")(ctx) is None
