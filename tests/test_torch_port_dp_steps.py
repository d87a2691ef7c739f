"""Data-parallel training steps on two gloo ranks against the port's
one-process step (``core/mesh.py``, ``train/driver.py``), noise and
dropout on, for CMLPL, CPS, CCT and CMLPL with the memory bank.

The ranks draw the whole batch's views and masks from copies of one
generator, run the forwards on their 12 of the step's 24 rows (rank 0's
block crosses the labeled/unlabeled boundary), gather the outputs and sum
the gradients, so the two-rank step is the one-process step up to the
order of the sums: the step-1 metrics, gradients and queues are held at
``FIRST_STEP_TOL`` (rtol 1e-5, atol 1e-6) of
``tests/test_torch_port_multi_run.py`` (measured: gradients within
3.5e-7, queues within 5e-8).  The draws are the same draws, so the
generators end bitwise equal to the one-process run's, and the two
replicas end bitwise equal to each other after 3 steps: params, Adam
moments and steps, queues, bank, generator.
"""

import numpy as np
import pytest
import torch

from torch_dist_worker import run_ranks, task_steps
from torch_port_threads import one_torch_thread  # noqa: F401

FIRST_STEP_TOL = dict(rtol=1e-5, atol=1e-6)
CASES = [("cmlpl", ""), ("cps", ""), ("cct", ""), ("cmlpl", "memobank")]
IDS = ["cmlpl", "cps", "cct", "cmlpl_memobank"]


@pytest.fixture(scope="module")
def all_runs(tmp_path_factory):
    """Every case on the same two ranks (one world), by case id."""
    calls = [["steps", dict(algo=a, extra_loss=e)] for a, e in CASES]
    ranks = run_ranks("many", str(tmp_path_factory.mktemp("steps")),
                      calls=calls)
    return {i: [r[k] for r in ranks] for k, i in enumerate(IDS)}


@pytest.fixture(scope="module", params=list(zip(IDS, CASES)),
                ids=IDS)
def runs(request, all_runs):
    case, (algo, extra) = request.param
    return dict(ranks=all_runs[case],
                one=task_steps(None, algo=algo, extra_loss=extra))


def test_first_step_metrics_match_one_process(runs):
    want = runs["one"]["metrics"][0]
    for r in runs["ranks"]:
        got = r["metrics"][0]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **FIRST_STEP_TOL)


def test_first_step_gradients_are_the_global_gradient(runs):
    """Summed over the ranks, not averaged: each rank holds its rows'
    share, so a mean (or a gather whose backward sums) misses by 2x."""
    want = runs["one"]["grads"]
    for r in runs["ranks"]:
        assert set(r["grads"]) == set(want)
        for k in want:
            np.testing.assert_allclose(r["grads"][k], want[k], err_msg=k,
                                       **FIRST_STEP_TOL)


def test_queues_and_bank_after_one_step_match_one_process(runs):
    want = runs["one"]["after1"]
    keys = [k for k in want if k.startswith(("queue", "bank"))]
    assert bool(keys) == (runs["one"]["metrics"][0].get("mask_rate")
                          is not None)
    for r in runs["ranks"]:
        for k in keys:
            np.testing.assert_allclose(r["after1"][k].numpy(),
                                       want[k].numpy(), err_msg=k,
                                       **FIRST_STEP_TOL)


def test_later_metrics_follow_the_one_process_run(runs):
    for step, want in enumerate(runs["one"]["metrics"]):
        for r in runs["ranks"]:
            for k in want:
                np.testing.assert_allclose(
                    r["metrics"][step][k], want[k], rtol=1e-4, atol=1e-5,
                    err_msg=f"step {step} {k}")


def test_replicas_are_bitwise_equal_after_3_steps(runs):
    a, b = (r["final"] for r in runs["ranks"])
    assert set(a) == set(b)
    assert any(k.startswith("opt") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert int(a["step"]) == 3


def test_placed_initial_state_is_the_one_process_state(runs):
    want = runs["one"]["initial"]
    for r in runs["ranks"]:
        for k in want:
            assert torch.equal(r["initial"][k], want[k]), k


def test_generators_draw_the_one_process_draws(runs):
    for r in runs["ranks"]:
        assert torch.equal(r["final"]["generator"],
                           runs["one"]["final"]["generator"])
