"""``utils/profiling.py`` (``trace``, ``StepTimer``) and ``cli.train
--profile_dir`` on the CPU (``cmlpl_tpu/utils/profiling.py``,
``cmlpl_tpu/cli/train.py:111-119``).  The trace is a Chrome trace JSON,
not a TensorBoard trace: the card's machine has no TensorBoard."""

import json

import pytest
import torch

from cmlpl_tpu_torch.cli import train as cli_train
from cmlpl_tpu_torch.utils.profiling import StepTimer, synchronize, trace
from torch_port_threads import one_torch_thread  # noqa: F401


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with trace(str(tmp_path / "prof")) as prof:
        (a @ a).sum()
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1 and prof is not None
    names = {e.get("name") for e in _events(files[0])}
    assert "aten::mm" in names


def test_cli_train_traces_its_first_run(tmp_path, capsys):
    cli_train.main([
        "--dataID", "0", "--n_PC", "16", "--num_epochs", "1",
        "--labeled_batch_size", "16", "--unlabeled_batch_size", "16",
        "--num_unlabel", "32", "--val_batch_size", "256", "--device", "cpu",
        "--eval_gather", "dense", "--print_per_batches", "0",
        "--save_path_prefix", str(tmp_path), "--profile_dir",
        str(tmp_path / "prof")])
    assert "training time ==" in capsys.readouterr().out
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in _events(files[0])}
    # the step's ops: the convolutions and Adam's update
    assert any("convolution" in str(n) for n in names)
    assert any("Optimizer.step" in str(n) for n in names)


def test_step_timer_reads_the_clock_after_a_synchronise(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: seen.append(device))
    timer = StepTimer()
    timer.start()
    dt = timer.stop(sync_on={"loss": torch.zeros(2)})
    assert dt >= 0 and timer.times == [dt] and timer.mean == dt
    assert seen == []           # a CPU tensor: nothing to wait for
    fake = torch.zeros(1)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    synchronize([fake])
    assert seen == [fake.device]


@pytest.mark.parametrize("tree", [None, [], {"a": 1}])
def test_synchronize_without_a_tensor_does_nothing(tree):
    synchronize(tree)
