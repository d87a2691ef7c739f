"""A fused 4-seed run (``EpochDriver.train_multi_run``) with its seeds
split over two gloo ranks on the CPU, against the one-process fused run.

Each rank trains 2 of the 4 seeds (``EpochDriver.seed_block``), drawing
every seed's schedule and keeping its own, so each seed sees the
one-process run's pool, schedule and draws: the generators end bitwise
equal and the metrics agree at ``METRIC_TOL`` of
``tests/test_torch_port_multi_run.py`` (a rank's grouped convolutions run
over 2 seeds, not 4, and sum in another order).  Three seeds do not
divide over two ranks: every rank then trains all three, with no
collective, as the JAX package's replicated fallback does.
"""

import numpy as np
import pytest
import torch

from cmlpl_tpu_torch.core.mesh import Mesh
from cmlpl_tpu_torch.train import CMLPLTrainer
from cmlpl_tpu_torch.train.state import CMLPLConfig
from torch_dist_worker import TINY, run_ranks, task_fused
from torch_port_threads import one_torch_thread  # noqa: F401

METRIC_TOL = dict(rtol=1e-4, atol=1e-5)


ALGOS = ("cmlpl", "cct")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both trainers' fused runs on the same two ranks, by trainer."""
    ranks = run_ranks("many", str(tmp_path_factory.mktemp("fused")),
                      calls=[["fused", dict(algo=a)] for a in ALGOS])
    return {a: [r[k] for r in ranks] for k, a in enumerate(ALGOS)}


@pytest.fixture(scope="module", params=ALGOS)
def fused(request, two_ranks):
    return dict(ranks=two_ranks[request.param],
                one=task_fused(None, algo=request.param))


def test_fused_seeds_split_over_the_ranks(fused):
    assert [tuple(r["block"]) for r in fused["ranks"]] == [(0, 2), (2, 4)]
    assert fused["one"]["block"] == (0, 4)
    for r in fused["ranks"]:
        assert len(r["states"]) == 2
        assert next(iter(r["metrics"].values())).shape[0] == 2


def test_fused_split_run_matches_the_one_process_fused_run(fused):
    one = fused["one"]
    for r in fused["ranks"]:
        lo, hi = r["block"]
        for k, v in one["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k].numpy(),
                                       v[lo:hi].numpy(), err_msg=k,
                                       **METRIC_TOL)
        for i, st in enumerate(r["states"]):
            want = one["states"][lo + i]
            assert torch.equal(st["generator"], want["generator"])
            assert int(st["step"]) == int(want["step"]) == 8




def test_seeds_that_do_not_divide_run_on_every_rank():
    for rank in (0, 1):
        trainer = CMLPLTrainer(CMLPLConfig(**TINY), device="cpu",
                               mesh=Mesh(rank, 2, torch.device("cpu")))
        assert trainer.seed_block(3) == (0, 3)
        assert trainer.seed_block(4) == ((0, 2), (2, 4))[rank]
