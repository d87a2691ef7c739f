"""``utils/profiling.CUPTI_SETTLE_S``: on the card, ``trace`` waits that
long after the profiler starts and before the traced block runs (CUPTI
may drop the records of the kernels launched first); with no card it
does not wait.  ``utils/profiler_check`` counts those drops on the card
and refuses to run without one."""

import contextlib

import pytest
import torch

from cmlpl_tpu_torch.utils import profiler_check, profiling
from torch_port_threads import one_torch_thread  # noqa: F401


class _FakeProfile(contextlib.AbstractContextManager):
    def __init__(self, log, activities):
        self.log = log
        log.append(("start", tuple(a.name for a in activities)))

    def __exit__(self, *exc):
        self.log.append(("stop",))

    def export_chrome_trace(self, path):
        self.log.append(("export",))


@pytest.mark.parametrize("card", [True, False])
def test_trace_waits_for_cupti_before_the_block_on_the_card(
        monkeypatch, tmp_path, card):
    log = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda activities: _FakeProfile(log, activities))
    monkeypatch.setattr(profiling.time, "sleep",
                        lambda s: log.append(("sleep", s)))
    with profiling.trace(str(tmp_path / "prof")):
        log.append(("block",))
    activities = ("CPU", "CUDA") if card else ("CPU",)
    waited = [("sleep", profiling.CUPTI_SETTLE_S)] if card else []
    assert log == [("start", activities), *waited, ("block",), ("stop",),
                   ("export",)]


def test_profiler_check_needs_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiler_check.main(["--seconds", "0"])
