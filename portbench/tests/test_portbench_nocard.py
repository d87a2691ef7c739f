"""Without a card the measurement path fails and prints no result; it
never falls back to the CPU."""

import pytest
import torch

from portbench import calibrate, run


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_run_refuses_without_a_card(no_card, capsys):
    rc = run.main(["--workload", "cmlpl-fused12-paviau", "--seed",
                   "2147483659", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    assert "no CUDA card" in out.err


def test_run_refuses_too_few_cards(monkeypatch, capsys):
    from portbench import registry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    cell = registry.cell("serve-paviau")
    rc = run.main(["--workload", cell.name, "--seed", "1", "--seconds",
                   "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_calibrate_refuses_without_a_card(no_card):
    assert calibrate.main(["--workload", "serve-paviau", "--mode", "sound",
                           "--seeds", "1"]) != 0
