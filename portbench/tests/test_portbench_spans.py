"""The readers of the program's spans (``prep_s.serve``, ``io_s.serve``,
``step_host_ms.train``, ``launches_per_step.train``,
``syncs_per_step.train``) on synthetic traces, and on the spans that the
program records in a profiled window, which they take from it."""

import sys
import time
import types

import pytest
import torch

from portbench import harness, registry
from portbench.profile import Profiled, Trace

T0, T1 = 1_000_000, 2_000_000
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class _Event:
    def __init__(self, name, a, b, kind):
        self._rec = (name, a, b - a, kind)

    def name(self):
        return self._rec[0]

    def start_ns(self):
        return self._rec[1]

    def duration_ns(self):
        return self._rec[2]

    def device_type(self):
        return self._rec[3]


@pytest.fixture
def program(monkeypatch):
    """``program(spans)``: the program's recorder hands over ``spans``
    ((name, start, end) in ns) that overlap the asked window, once."""
    from cmlpl_tpu_torch.utils import profiling

    def give(spans):
        left = [types.SimpleNamespace(name=n, start_ns=a, end_ns=b)
                for n, a, b in spans]

        def take_spans(t0=None, t1=None):
            out = [s for s in left if s.end_ns >= t0 and s.start_ns <= t1]
            left.clear()
            return out
        monkeypatch.setattr(profiling, "take_spans", take_spans)
    return give


def _read(metric, host=(), device=()):
    events = ([_Event(n, a, b, CPU) for n, a, b in host]
              + [_Event(n, a, b, CUDA) for n, a, b in device])
    trace = Trace(events, T0, T1)
    ctx = harness.Context(None, 0.0, {}, trace, None)
    return registry.reader(metric)(ctx)


def test_prep_s_reads_the_mean_prep_inside_the_window(program):
    spans = [("serve.prep", T0 + 100, T0 + 400_100),
             ("serve.prep", T0 + 500_000, T0 + 700_000),
             ("serve.prep", T1 - 100, T1 + 500_000),   # past the window
             ("prep.pca", T0 + 100, T0 + 300_100),
             ("request (server: read, prep, map, write)", T0, T1)]
    program(spans)
    assert _read("prep_s.serve") == pytest.approx(300_000e-9)
    program(spans[2:])
    assert _read("prep_s.serve") is None


def test_io_s_adds_the_mean_read_and_the_mean_write(program):
    spans = [("serve.read", T0 + 10, T0 + 110),
             ("serve.read", T0 + 1000, T0 + 1300),
             ("serve.write", T0 + 200, T0 + 250),
             ("serve.write", T0 - 10, T0 + 5000)]    # begun before it
    program(spans)
    assert _read("io_s.serve") == pytest.approx(250e-9)
    program(spans[:2])
    assert _read("io_s.serve") is None


STEPS = [("train.step", T0 + 1000, T0 + 2000),
         ("train.step", T0 + 3000, T0 + 4000),
         ("train.step", T1 - 500, T1 + 500)]         # past the window


def test_step_host_ms_subtracts_the_runtime_calls_inside_each_step(
        program):
    host = [("cudaLaunchKernel", T0 + 900, T0 + 1100),    # straddles
            ("cudaLaunchKernel", T0 + 1500, T0 + 1600),
            ("cudaStreamSynchronize", T0 + 1550, T0 + 1700),  # overlaps
            ("aten::mm", T0 + 1200, T0 + 1300),     # not a runtime call
            ("cudaMemcpyAsync", T0 + 3900, T0 + 4200),
            ("cudaLaunchKernel", T0 + 2500, T0 + 2600)]   # between steps
    # step 1: 1000 less 100 + 200; step 2: 1000 less 100
    want = ((1000 - 300) + (1000 - 100)) / 2 * 1e-6
    program(STEPS)
    assert _read("step_host_ms.train", host) == pytest.approx(want)


@pytest.mark.parametrize("metric,names,want", [
    ("launches_per_step.train",
     ["cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
      "cudaGraphLaunch"], 4 / 2),
    ("syncs_per_step.train",
     ["cudaStreamSynchronize", "cudaDeviceSynchronize",
      "cudaEventSynchronize", "cudaMemcpy"], 4 / 2),
])
def test_per_step_counts_take_the_calls_that_start_inside_steps(
        program, metric, names, want):
    inside = [(n, T0 + 1100 + 10 * k, T0 + 1105 + 10 * k)
              for k, n in enumerate(names)]
    others = [("cudaMemcpyAsync", T0 + 3100, T0 + 3200),
              ("cudaEventRecord", T0 + 3300, T0 + 3400),
              (names[0], T0 + 900, T0 + 1100),        # begun before
              (names[0], T0 + 2500, T0 + 2600),       # between steps
              (names[0], T1 - 100, T1 - 50)]          # in the cut step
    program(STEPS)
    assert _read(metric, inside + others) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["step_host_ms.train",
                                    "launches_per_step.train",
                                    "syncs_per_step.train"])
def test_step_readers_need_steps_and_a_traced_card(program, metric):
    host = [("cudaLaunchKernel", T0 + 1100, T0 + 1200)]
    program(STEPS)
    assert _read(metric, [("aten::mm", T0 + 1100, T0 + 1200)]) is None
    program([])
    assert _read(metric, host) is None
    program(STEPS)
    assert _read(metric, host) is not None


def test_the_readers_of_a_profiled_window_share_the_programs_spans():
    from cmlpl_tpu_torch.utils.profiling import span, take_spans
    with Profiled(torch.device("cpu")) as prof:
        with span("serve.request"):
            with span("serve.read"):
                time.sleep(0.01)
            with span("serve.prep"):
                time.sleep(0.05)
            with span("serve.write"):
                time.sleep(0.01)
    ctx = harness.Context(None, 0.0, {}, prof.trace, None)
    prep = registry.reader("prep_s.serve")(ctx)
    io = registry.reader("io_s.serve")(ctx)
    assert 0.05 <= prep < 0.5
    assert 0.02 <= io < 0.5
    # taken from the program once: the second reader read the same list
    assert registry.reader("prep_s.serve")(ctx) == prep
    assert take_spans() == []


def test_a_program_without_a_recorder_reads_nothing(monkeypatch):
    # a program with no recorder: its import fails
    monkeypatch.setitem(sys.modules, "cmlpl_tpu_torch.utils.profiling", None)
    with Profiled(torch.device("cpu")) as prof:
        with prof.span("request (server: read, prep, map, write)"):
            time.sleep(0.3)
    ctx = harness.Context(None, 0.0, {}, prof.trace, None)
    for metric in ("prep_s.serve", "io_s.serve", "step_host_ms.train",
                   "launches_per_step.train", "syncs_per_step.train"):
        assert registry.reader(metric)(ctx) is None
    (gap,) = prof.trace.breakdown()["idle_gaps"]
    assert gap[0] == "request (server: read, prep, map, write) / -"
