"""The port's data mesh (``cmlpl_tpu_torch/core/mesh.py``) on the CPU:
``initialize_multihost`` and the ``--multihost`` flag in one process, the
refusals the JAX package makes (a per-step kernel gather over ranks, a
batch that does not divide over them), the one the port adds
(``cli.train_backbone --multihost``), the device a rank takes, and the
gather ``Function`` on two gloo ranks (``tests/torch_dist_worker.py``).

The gather is exact (an all-reduce of a zero-filled buffer), and its
backward is the rank's rows of the output's gradient: 24 rows, 8 labeled
and 16 unlabeled, split 12/12, so rank 0's block crosses the boundary.
"""

import jax
import numpy as np
import pytest
import torch

from cmlpl_tpu.core.mesh import create_mesh as jax_create_mesh
from cmlpl_tpu.ops.patch_gather import check_gather_mesh as jax_check
from cmlpl_tpu.train import CCTTrainer as JaxCCTTrainer
from cmlpl_tpu.train import CMLPLConfig as JaxConfig
from cmlpl_tpu.train import CMLPLTrainer as JaxCMLPLTrainer
from cmlpl_tpu.train import CPSTrainer as JaxCPSTrainer
from cmlpl_tpu_torch.cli import train_backbone
from cmlpl_tpu_torch.cli._common import setup_runtime, train_parser
from cmlpl_tpu_torch.core import mesh as mesh_lib
from cmlpl_tpu_torch.core.mesh import (Mesh, create_mesh,
                                       initialize_multihost)
from cmlpl_tpu_torch.device import resolve_device
from cmlpl_tpu_torch.ops.patch_gather import (TRAIN_GATHERS,
                                              check_gather_mesh,
                                              resolve_train_gather)
from cmlpl_tpu_torch.train import CCTTrainer, CMLPLTrainer, CPSTrainer
from cmlpl_tpu_torch.train.state import CMLPLConfig
from torch_dist_worker import TINY, run_ranks, task_gather
from torch_port_threads import one_torch_thread  # noqa: F401

TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
            "LOCAL_RANK")
PAIRS = [(CMLPLTrainer, JaxCMLPLTrainer), (CPSTrainer, JaxCPSTrainer),
         (CCTTrainer, JaxCCTTrainer)]


@pytest.fixture
def one_process(monkeypatch):
    for var in TORCHRUN:
        monkeypatch.delenv(var, raising=False)


def test_initialize_multihost_single_process_noop(one_process):
    assert initialize_multihost() == 1
    assert initialize_multihost(device="cpu") == 1
    assert not torch.distributed.is_initialized()
    mesh = create_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, None)
    assert not mesh_lib.is_distributed(mesh) and mesh_lib.is_primary(mesh)


def test_multihost_cli_flag_single_process(one_process, capsys):
    args = train_parser().parse_args(["--multihost", "--device", "cpu"])
    setup_runtime(args)     # must not raise nor start a process group
    assert "multihost: 1 process(es)" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()


def test_a_rank_takes_its_local_card(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda:1")
    # the training CLIs' old default, "--device cuda", is the rank's card
    assert resolve_device("cuda") == torch.device("cuda:1")
    assert resolve_device("cuda:0") == torch.device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cuda") == torch.device("cuda")


def test_a_single_process_without_cuda_still_raises(one_process,
                                                    monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)


@pytest.mark.parametrize("size", [1, 2, 4, 8])
@pytest.mark.parametrize("impl", [g for g in TRAIN_GATHERS if g != "auto"])
def test_check_gather_mesh_refuses_what_jax_refuses(impl, size):
    jmesh = jax_create_mesh(jax.devices()[:size])
    try:
        jax_check(impl, jmesh)
        jax_raises = False
    except ValueError:
        jax_raises = True
    mesh = Mesh(0, size, torch.device("cpu"))
    if jax_raises:
        with pytest.raises(ValueError, match="single-rank mesh"):
            check_gather_mesh(impl, mesh)
    else:
        check_gather_mesh(impl, mesh)
    check_gather_mesh(impl, None)
    assert jax_raises == (impl in ("pallas", "pallas_bf16") and size > 1)


@pytest.mark.parametrize("impl", ["pallas", "pallas_bf16"])
def test_trainer_refuses_a_kernel_gather_over_ranks(impl):
    with pytest.raises(ValueError, match="single-rank mesh"):
        CMLPLTrainer(CMLPLConfig(**TINY, gather_impl=impl), device="cpu",
                     mesh=Mesh(0, 2, torch.device("cpu")))


def test_auto_over_the_budget_over_ranks_resolves_as_on_one_card():
    """Over the pool's budget "auto" over two ranks is not refused (JAX
    resolves it to "xla" first) and resolves as on one card: the plain
    gather on the CPU, kernel 1 each step on the card, where every rank
    gathers its whole batch itself."""
    big = dict(TINY, num_unlabel=10_000_000)
    two = Mesh(0, 2, torch.device("cpu"))
    trainer = CMLPLTrainer(CMLPLConfig(**big), device="cpu", mesh=two)
    assert trainer.config.gather_impl == "xla"
    check_gather_mesh("auto", two)
    assert resolve_train_gather(
        "auto", torch.device("cuda"), num_unlabel=big["num_unlabel"],
        patch_size=big["patch_size"], n_pc=big["n_pc"]) == "pallas"


@pytest.mark.parametrize("port,jax_cls", PAIRS,
                         ids=["cmlpl", "cps", "cct"])
@pytest.mark.parametrize("batches", [(9, 16), (8, 15)])
def test_batches_that_do_not_divide_are_refused(port, jax_cls, batches):
    lb, ub = batches
    cfg = dict(TINY, labeled_batch=lb, unlabeled_batch=ub,
               gather_impl="xla")
    with pytest.raises(ValueError, match="divisible by the mesh"):
        jax_cls(JaxConfig(**cfg), mesh=jax_create_mesh(jax.devices()[:2]),
                donate=False)
    with pytest.raises(ValueError, match="divisible by the mesh"):
        port(CMLPLConfig(**cfg), device="cpu",
             mesh=Mesh(0, 2, torch.device("cpu")))
    # one rank takes any batch
    port(CMLPLConfig(**cfg), device="cpu",
         mesh=Mesh(0, 1, torch.device("cpu")))


def test_stacked_nets_are_refused_over_ranks():
    with pytest.raises(ValueError, match="stack_nets"):
        CMLPLTrainer(CMLPLConfig(**TINY, stack_nets=True), device="cpu",
                     mesh=Mesh(0, 2, torch.device("cpu")))


def test_train_backbone_multihost_is_not_ported(one_process, tmp_path,
                                               capsys):
    """Named for the refusal it held until the supervised trainer ran
    over ranks: ``--multihost`` on one process now joins no world and
    trains, as the other training CLIs do (two ranks:
    ``tests/test_torch_port_dp_dense.py``)."""
    acc = train_backbone.main(["--dataID", "0", "--device", "cpu",
                               "--multihost", "--num_epochs", "1",
                               "--save_path_prefix", str(tmp_path)])
    assert "multihost: 1 process(es)" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
    assert 0.0 <= acc.oa <= 1.0


def test_mesh_rows_are_contiguous_blocks():
    got = [Mesh(r, 4, torch.device("cpu")).rows(24) for r in range(4)]
    assert got == [(0, 6), (6, 12), (12, 18), (18, 24)]
    with pytest.raises(ValueError, match="do not divide"):
        Mesh(0, 4, torch.device("cpu")).rows(10)
    assert mesh_lib.pad_to_multiple(3072, 1024 * 2) == 4096


def test_one_process_collectives_are_the_identity():
    x = torch.randn(6, 3, requires_grad=True)
    mesh = Mesh(0, 1, torch.device("cpu"))
    for m in (None, mesh):
        assert mesh_lib.shard_rows(x, m) is x
        assert mesh_lib.all_gather_rows(x, m) is x
        assert mesh_lib.gather_rows(x, m, 0, 6) is x
    assert mesh_lib.place_state(mesh, None, "state") == "state"


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_ranks("gather", str(tmp_path_factory.mktemp("gather")))


def test_gather_forward_is_exact(two_ranks):
    for r in two_ranks:
        assert torch.equal(r["gathered"], r["x"])
        assert torch.equal(r["bf16"], r["x"].to(torch.bfloat16))
        assert r["bf16"].dtype == torch.bfloat16
        assert torch.equal(r["int32"],
                           torch.arange(24, dtype=torch.int32) * 7)
    assert [(r["lo"], r["hi"]) for r in two_ranks] == [(0, 12), (12, 24)]


def test_gather_backward_is_the_local_slice(two_ranks):
    """Not the sum over ranks (2x): each rank's rows of the gradient."""
    for r in two_ranks:
        assert torch.equal(r["grad"], r["w"][r["lo"]:r["hi"]])


def test_sharded_call_completes_its_input_gradient(two_ranks):
    """A sharded call on a replicated input that needs a gradient (CCT's
    heads): the input's gradient is the one-process gradient on every
    rank, and the call's gathered output is the one-process output."""
    one = task_gather(None)
    for r in two_ranks:
        np.testing.assert_allclose(r["out"], one["out"], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(r["rep_grad"], one["rep_grad"],
                                   rtol=1e-6, atol=1e-6)
    assert torch.equal(two_ranks[0]["rep_grad"], two_ranks[1]["rep_grad"])


def test_initialize_multihost_is_idempotent_in_a_world(tmp_path):
    got = run_ranks("init", str(tmp_path))
    assert [(r["again"], r["rank"], r["size"], r["backend"])
            for r in got] == [(2, 0, 2, "gloo"), (2, 1, 2, "gloo")]
