"""The training CLIs with ``--multihost`` over two gloo ranks on the CPU
(``tests/torch_dist_worker.py`` starts the ranks with torchrun's
environment).

``cli.train --multihost`` maps each net with one strip of tiles a
rank, so both ranks report the same OA, the one-process run's within
1.0 point (the two-rank gradient is the one-process gradient within
rounding); rank 0 alone writes the CSV, the SVG and the metrics CSV; a
``--checkpoint_dir`` run restores the same state on both ranks, and a
``--resume`` run continues from it, also when rank 0 alone can see the
checkpoints.  ``cli.train --fused_iters`` splits
its 4 seeds and reports all of them on each rank; ``cli.train_cps`` and
``cli.train_cct`` report one OA on both ranks.
"""

import os

import pytest
import torch

from cmlpl_tpu_torch.cli import train as cli_train
from torch_dist_worker import run_ranks
from torch_port_threads import one_torch_thread  # noqa: F401

TINY = ["--dataID", "0", "--n_PC", "16", "--labeled_batch_size", "8",
        "--unlabeled_batch_size", "16", "--num_unlabel", "64",
        "--val_batch_size", "256", "--device", "cpu", "--num_epochs", "1"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    ck = str(tmp / "ck")
    runs = [("train", TINY + ["--multihost", "--checkpoint_dir", ck,
                              "--save_path_prefix", "a", "--metrics_csv",
                              "m.csv"]),
            ("train", TINY[:-1] + ["2", "--multihost", "--checkpoint_dir",
                                   ck, "--resume", "--save_path_prefix",
                                   "b"]),
            ("train", TINY + ["--multihost", "--num_iters", "4",
                              "--fused_iters", "--save_path_prefix", "c",
                              "--weights_out", "w.npz"]),
            ("train_cps", TINY + ["--multihost", "--save_path_prefix", "d"]),
            ("train_cct", TINY + ["--multihost", "--save_path_prefix", "e"]),
            # rank 0 alone sees the checkpoints: rank 1's directory is
            # one that no rank writes
            ("train", [TINY[:-1] + ["3", "--multihost", "--checkpoint_dir",
                                    d, "--resume", "--save_path_prefix",
                                    "f"] for d in (ck, str(tmp / "no_ck"))])]
    ranks = run_ranks("cli", str(tmp / "ranks"), timeout=400, runs=runs,
                      cwd=str(tmp))
    one_dir = tmp / "one"
    one_dir.mkdir()
    cwd = os.getcwd()
    os.chdir(one_dir)
    try:
        one = cli_train.main(TINY)
    finally:
        os.chdir(cwd)
    return dict(ranks=ranks, one=[a.oa for a in one], tmp=tmp)


def test_cli_ranks_report_the_same_oa(cli_runs):
    a, b = (r["oa"] for r in cli_runs["ranks"])
    assert a == b
    assert [len(x) for x in a] == [2, 2, 2, 2, 1, 2]


def test_cli_two_ranks_within_a_point_of_one_process(cli_runs):
    got = cli_runs["ranks"][0]["oa"][0]
    for g, w in zip(got, cli_runs["one"]):
        assert abs(g - w) * 100 <= 1.0, (got, cli_runs["one"])


def test_cli_rank_0_alone_writes_the_files(cli_runs):
    tmp = cli_runs["tmp"]
    for prefix, name in (("a", "cmlpl"), ("b", "cmlpl"), ("c", "cmlpl"),
                         ("d", "cps"), ("e", "cct"), ("f", "cmlpl")):
        files = sorted(os.listdir(tmp / prefix / "Experiment_0" /
                                  "label_5"))
        csvs = [f for f in files if f.endswith(".csv")]
        svgs = [f for f in files if f.endswith(".svg")]
        assert csvs == [f"{name}_results.csv"], files
        # the 4 fused seeds' maps are named by their OAs, which may tie
        assert (1 <= len(svgs) <= 4) if prefix == "c" else len(svgs) == 1

    with open(tmp / "m.csv") as f:
        assert f.readline().startswith("step,")
    assert os.path.exists(tmp / "w.npz")
    for r in cli_runs["ranks"]:
        assert "multihost: 2 process(es)" in r["printed"][0]


def test_cli_resume_restores_the_same_state_on_both_ranks(cli_runs):
    a, b = (r["resumed"] for r in cli_runs["ranks"])
    assert len(a) == len(b) == 3
    for sa, sb in zip(a, b):
        assert set(sa) == set(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for r in cli_runs["ranks"]:
        assert "resumed from step 4 (epoch 1)" in r["printed"][1]


def test_cli_resume_reads_the_checkpoint_on_rank_0_alone(cli_runs):
    """Rank 1's --checkpoint_dir holds nothing and is never written: both
    ranks resume from rank 0's step-8 checkpoint all the same, and train
    the third epoch from it."""
    for r in cli_runs["ranks"]:
        assert "resumed from step 8 (epoch 2)" in r["printed"][5]
        assert "(4 steps)" in r["printed"][5]
    assert not os.path.exists(cli_runs["tmp"] / "no_ck")
    assert sorted(os.listdir(cli_runs["tmp"] / "ck")) == ["12", "4", "8"]


def test_cli_fused_reports_every_seed_on_every_rank(cli_runs):
    for r in cli_runs["ranks"]:
        text = r["printed"][2]
        assert text.count("Result (net B)") == 4
        assert "mean_OA ± std_OA is:" in text
