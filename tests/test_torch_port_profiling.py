"""``utils/profiling.py`` (``trace``, ``span``) and ``cli.train
--profile_dir`` on the CPU (``cmlpl_tpu/utils/profiling.py``,
``cmlpl_tpu/cli/train.py:111-119``).  The trace is a Chrome trace JSON,
not a TensorBoard trace: the card's machine has no TensorBoard."""

import json

import torch

from cmlpl_tpu_torch.cli import train as cli_train
from cmlpl_tpu_torch.utils.profiling import SPAN_TID, span, trace
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


def test_trace_writes_the_program_spans_on_a_row_of_their_own(tmp_path):
    a = torch.randn(64, 64)
    with trace(str(tmp_path / "prof")):
        with span("outer", id=7):
            with span("inner"):
                (a @ a).sum()
    events = _events(next((tmp_path / "prof").glob("trace_*.json")))
    spans = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(spans) == {"outer", "inner"}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["ph"] == inner["ph"] == "X"
    assert outer["tid"] == inner["tid"] == SPAN_TID
    assert outer["args"]["id"] == "7"
    assert inner["args"]["parent"] == outer["args"]["index"]
    assert {outer["args"]["root"], inner["args"]["root"]} == {
        outer["args"]["index"]}
    assert any(e.get("name") == "thread_name" and e.get("tid") == SPAN_TID
               for e in events)
    # on the trace's time base: the product's op lies inside both spans
    mm = next(e for e in events if e.get("name") == "aten::mm")
    for s in (outer, inner):
        assert s["ts"] <= mm["ts"]
        assert mm["ts"] + mm["dur"] <= s["ts"] + s["dur"]
