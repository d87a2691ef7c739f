"""Each cell end to end on the CPU at a tiny size (``tiny.py``), past
the command's look for a card: a sound run comes out correct, and a run
with a fault planted under the timed path comes out not correct."""

import math
import time

import pytest
import torch

from portbench import faults, harness
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(name, trace=False):
    return harness.run(tiny.cell(name), SEED, 0.5, trace, CPU,
                       time.perf_counter())


@pytest.mark.parametrize("name", sorted(tiny.TINY))
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    e2e = {m["name"] for m in tiny.cell(name).end_to_end}
    assert set(out["metrics"]) == e2e
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in out["metrics"].values())


@pytest.mark.parametrize("name,fault", [
    ("cmlpl-fused12-paviau", "unchanged"),
    ("cmlpl-fused12-paviau", "half"),
    ("ssrn-train-paviau", "unchanged"),
    ("ssrn-train-paviau", "half"),
    ("serve-paviau", "altered"),
])
def test_fault_is_caught(name, fault):
    with faults.planted(fault, tiny.cell(name).config["classes"]):
        out = _run(name)
    assert not out["correct"], out["checks"]


def test_traced_run_on_the_cpu_reads_no_device_metric():
    out = _run("ssrn-train-paviau", trace=True)
    # no device records on the CPU: the readers return nothing
    assert out["metrics"] == {}
    assert out["device"]["busy_s"] == 0.0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
