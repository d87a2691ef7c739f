"""``predict`` and ``serve`` from a checkpoint of the port's trainers
(``--checkpoint_dir``, ``--net b|e``; ``cmlpl_tpu/cli/predict.py:29-45``,
``cmlpl_tpu/cli/serve.py:45-59``), on the CPU.

A checkpoint holds the trained params bitwise, as ``--weights_out`` does,
so the maps from the two are equal, pixel for pixel.
"""

import io
import json

import numpy as np
import pytest
import torch

from cmlpl_tpu_torch.cli import predict, serve
from cmlpl_tpu_torch.cli import train as cli_train
from cmlpl_tpu_torch.cli import train_cct as cli_train_cct
from cmlpl_tpu_torch.cli._common import logits_fn
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.eval.inference import ScenePredictor
from cmlpl_tpu_torch.train import CMLPLTrainer
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.utils.checkpoint import (load_net_params,
                                              restore_checkpoint)
from torch_port_threads import one_torch_thread  # noqa: F401

N_PC, TILE = 16, 256
TRAIN = ["--dataID", "0", "--n_PC", str(N_PC), "--num_epochs", "1",
         "--labeled_batch_size", "16", "--unlabeled_batch_size", "16",
         "--num_unlabel", "160", "--val_batch_size", str(TILE),
         "--dropout", "0.5", "--device", "cpu", "--print_per_batches", "0",
         "--eval_gather", "dense"]
MAP = ["--dataID", "0", "--n_PC", str(N_PC), "--val_batch_size", str(TILE),
       "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One tiny cli.train run with a checkpoint and --weights_out."""
    tmp = tmp_path_factory.mktemp("trained")
    cli_train.main(TRAIN + ["--save_path_prefix", str(tmp),
                            "--checkpoint_dir", str(tmp / "ck"),
                            "--weights_out", str(tmp / "w.npz")])
    predict.main(MAP + ["--weights", str(tmp / "w.npz"), "--out",
                        str(tmp / "w.svg")])
    return tmp


def test_net_b_of_a_checkpoint_maps_as_its_weights(trained, tmp_path):
    """The tiled map, the serving path."""
    predict.main(MAP + ["--checkpoint_dir", str(trained / "ck"), "--out",
                        str(tmp_path / "b.svg")])
    assert ((tmp_path / "b.svg").read_bytes()
            == (trained / "w.svg").read_bytes())


def test_net_e_of_a_checkpoint_maps_net_e(trained, tmp_path, capsys):
    got = predict.main(MAP + ["--checkpoint_dir", str(trained / "ck"),
                              "--net", "e", "--eval_gather", "dense",
                              "--out", str(tmp_path / "e.svg")])
    assert "Result (net E)" in capsys.readouterr().out
    trainer = CMLPLTrainer(CMLPLConfig(num_features=103, n_pc=N_PC,
                                       dropout=0.5, labeled_batch=16,
                                       unlabeled_batch=16, num_unlabel=160),
                           device="cpu")
    state = restore_checkpoint(str(trained / "ck"), trainer)
    model = state.net_e.model.eval()
    scene = prepare_scene(0, patch_size=20, n_pc=N_PC, device="cpu")
    want = ScenePredictor(logits_fn(model), params=model.state_dict(),
                          patch_size=20, cols=scene.cols, tile=TILE,
                          gather="dense")(scene)
    np.testing.assert_array_equal(got, want)
    # the two nets differ, so --net chose
    b = load_net_params(str(trained / "ck"), "b")
    e = load_net_params(str(trained / "ck"), "e")
    assert not np.array_equal(b["conv0"]["kernel"], e["conv0"]["kernel"])


def test_serve_answers_from_a_checkpoint(trained, tmp_path):
    stdout = io.StringIO()
    serve.main(MAP + ["--checkpoint_dir", str(trained / "ck"),
                      "--no_warmup"],
               stdin=io.StringIO(json.dumps(
                   {"id": "r", "out": str(tmp_path / "m.svg")}) + "\n"),
               stdout=stdout)
    lines = [json.loads(s) for s in stdout.getvalue().splitlines()]
    assert lines[0]["ready"] is True
    assert lines[1]["id"] == "r" and "error" not in lines[1]
    assert lines[1]["pixels"] == 64 * 48
    assert ((tmp_path / "m.svg").read_bytes()
            == (trained / "w.svg").read_bytes())


@pytest.mark.parametrize("entry", ["predict", "serve"])
def test_both_sources_are_refused(trained, entry):
    main = {"predict": predict.main, "serve": serve.main}[entry]
    with pytest.raises(SystemExit, match="--weights.*--checkpoint_dir"):
        main(MAP + ["--weights", str(trained / "w.npz"), "--checkpoint_dir",
                    str(trained / "ck")])


def test_a_checkpoint_without_two_nets_is_refused(tmp_path):
    cli_train_cct.main(TRAIN + ["--save_path_prefix", str(tmp_path),
                                "--num_unlabel", "32", "--checkpoint_dir",
                                str(tmp_path / "ck")])
    with pytest.raises(KeyError, match="net_b"):
        predict.main(MAP + ["--checkpoint_dir", str(tmp_path / "ck")])
    with pytest.raises(FileNotFoundError):
        predict.main(MAP + ["--checkpoint_dir", str(tmp_path / "none")])


def test_the_card_is_the_default(monkeypatch, trained):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(["--dataID", "0", "--checkpoint_dir",
                      str(trained / "ck")])
