"""bf16-compute training on the CPU: the port's input cast, bf16 pool, bf16
noise sampler and the three trainers under ``compute_dtype="bfloat16"``
vs the JAX package's.

Step parity follows ``tests/test_torch_port_train_step.py``: noise and
dropout off (Philox is not threefry), both packages from the JAX trainer's
state, the same 4 steps on the 64x48 scene at n_PC 16, pool gather.
Tolerances are bf16's: each conv and dense layer rounds its output to an
8-bit mantissa (2**-8 = 3.9e-3 of its size), at other points inside the
layer in XLA:CPU and oneDNN, and the losses are batch means of such
outputs: rtol and atol 2e-3 (the measured worst is 1.3e-3).  A weight
whose gradient lies within that rounding of 0 can take Adam steps of
either sign, up to lr = 5e-4 each, so every weight is held to twice the
Adam steps it takes (4 steps; CCT's encoder takes two a step), and 99% of
the weights to one Adam step (the measured 99th percentile is 2.3e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmlpl_tpu.data import SemiSupervisedSampler as JaxSampler
from cmlpl_tpu.data import generate_splits as jax_generate_splits
from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.ops.patch_gather import make_input_cast as jax_input_cast
from cmlpl_tpu.train import CCTTrainer as JaxCCTTrainer
from cmlpl_tpu.train import CMLPLConfig as JaxConfig
from cmlpl_tpu.train import CMLPLTrainer as JaxCMLPLTrainer
from cmlpl_tpu.train import CPSTrainer as JaxCPSTrainer
from cmlpl_tpu_torch.cli import train as cli_train
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.models.basenet import BaseNet2
from cmlpl_tpu_torch.ops import patch_gather as pg
from cmlpl_tpu_torch.ops.noise import make_noiser, normal
from cmlpl_tpu_torch.train import CCTTrainer, CMLPLTrainer, CPSTrainer
from cmlpl_tpu_torch.train.state import CMLPLConfig
from cmlpl_tpu_torch.weights import init_basenet2_params, state_dict_from_jax
from torch_port_threads import one_torch_thread  # noqa: F401

N_PC, W = 16, 20
TINY = dict(num_classes=9, num_features=103, n_pc=N_PC, patch_size=W,
            labeled_batch=8, unlabeled_batch=16, num_unlabel=64,
            num_epochs=2, noise=0.0, dropout=0.0, thr=0.13, queue_batch=1,
            compute_dtype="bfloat16", gather_impl="pool")
STEPS = [(0, 0), (0, 2), (1, 0), (1, 1)]   # (epoch, batch index)
LOSS_TOL = dict(rtol=2e-3, atol=2e-3)
LR = 5e-4
TRAINERS = {"cmlpl": (JaxCMLPLTrainer, CMLPLTrainer),
            "cps": (JaxCPSTrainer, CPSTrainer),
            "cct": (JaxCCTTrainer, CCTTrainer)}


@pytest.fixture(scope="module")
def scenes():
    cube, gt = synthetic_scene(0)
    return (jax_prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC),
            prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC,
                          device="cpu"))


# ------------------------------------------------------------ input cast

@pytest.mark.parametrize("compute_dtype,input_dtype", [
    ("float32", "compute"), ("float32", "float32"),
    ("bfloat16", "compute"), ("bfloat16", "float32")])
def test_make_input_cast_matches_jax(rng, compute_dtype, input_dtype):
    a = rng.normal(size=(5, 7)).astype(np.float32)
    got = pg.make_input_cast(compute_dtype, input_dtype)(torch.from_numpy(a))
    want = np.asarray(jax_input_cast(compute_dtype, input_dtype)(
        jnp.asarray(a)))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    # the cast also upcasts the bf16 kernel's patches under f32 inputs
    b = torch.from_numpy(a).to(torch.bfloat16)
    assert pg.make_input_cast(compute_dtype, input_dtype)(b).dtype == \
        got.dtype


def test_make_input_cast_rejects_unknown_dtypes():
    for bad in ("float16", "bf16"):
        with pytest.raises(ValueError, match="input_dtype"):
            pg.make_input_cast("bfloat16", bad)
        with pytest.raises(ValueError, match="input_dtype"):
            jax_input_cast("bfloat16", bad)
        with pytest.raises(ValueError, match="input_dtype"):
            CMLPLTrainer(CMLPLConfig(input_dtype=bad), device="cpu")


# ------------------------------------------------------------ bf16 pool

def test_bf16_pool_is_the_cast_f32_pool(scenes, rng):
    """Kernel 2's plain path over ``padded.to(bf16)`` is bitwise the bf16
    cast of kernel 1's f32 pool, and the spectra are the cast rows."""
    _, scene = scenes
    ids = torch.from_numpy(rng.integers(0, scene.num_pixels, 512)
                           .astype(np.int32))
    xp32, x32 = pg.gather_pool(scene.padded_pca, scene.spectra, ids,
                               cols=scene.cols, w=W)
    cast = pg.make_input_cast("bfloat16", "compute")
    xp16, x16 = pg.gather_pool(cast(scene.padded_pca), scene.spectra, ids,
                               cols=scene.cols, w=W)
    assert xp32.dtype == torch.float32 and xp16.dtype == torch.bfloat16
    assert torch.equal(xp16.view(torch.int16),
                       xp32.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(cast(x16), x32.to(torch.bfloat16))


@pytest.mark.parametrize("input_dtype", ["compute", "float32"])
def test_bf16_trainer_gathers_its_pool_with_kernel_2(scenes, monkeypatch,
                                                     input_dtype):
    """Under bf16 inputs the trainer's pool comes from kernel 2's wrapper
    over the bf16 cube; under f32 inputs from kernel 1's."""
    _, scene = scenes
    calls = []
    for name in ("gather_patches_f32", "gather_patches_bf16"):
        real = getattr(pg, name)
        monkeypatch.setattr(pg, name, lambda cube, *a, _r=real, _n=name,
                            **k: calls.append((_n, cube.dtype)) or
                            _r(cube, *a, **k))
    trainer = CMLPLTrainer(CMLPLConfig(**dict(TINY, input_dtype=input_dtype)),
                           device="cpu")
    rng = np.random.default_rng(0)
    li = rng.integers(0, scene.num_pixels, (1, 8))
    ui = rng.integers(0, scene.num_pixels, (1, 16))
    trainer.train_epoch(trainer.init_state(0), scene, li,
                        scene.labels[li] - 1, ui)
    assert calls == ([("gather_patches_bf16", torch.bfloat16)]
                     if input_dtype == "compute"
                     else [("gather_patches_f32", torch.float32)])


def test_pallas_bf16_step_gather_keeps_bf16(scenes, rng):
    """The per-step bf16 gather returns kernel 2's patches; the f32-input
    cast upcasts them and the bf16-input cast leaves the same bits."""
    _, scene = scenes
    prep, gather = pg.make_train_gather("pallas_bf16", N_PC)
    ids = torch.from_numpy(rng.integers(0, scene.num_pixels, 32)
                           .astype(np.int32))
    out = gather(prep(scene.padded_pca), ids, scene.cols, W)
    assert out.dtype == torch.bfloat16
    up = pg.make_input_cast("float32", "compute")(out)
    assert up.dtype == torch.float32
    assert torch.equal(
        pg.make_input_cast("bfloat16", "compute")(out).view(torch.int16),
        up.to(torch.bfloat16).view(torch.int16))


# ------------------------------------------------------------ bf16 noise

def test_bf16_normal_follows_the_jax_sampler():
    """2**20 draws each.  JAX's bf16 normal takes 128 values (a 7-bit
    uniform through sqrt(2) erfinv), the largest |z| 2.890625; the port's
    takes only values of JAX's set, each with frequency 1/128 within 5
    standard errors, and its variance lies within 1e-2 of the JAX
    sample's (the sd of a sample variance is 1.4e-3 here)."""
    n = 1 << 20
    jz = np.asarray(jax.random.normal(jax.random.key(0), (n,),
                                      jnp.bfloat16)).astype(np.float32)
    levels = np.unique(jz)
    assert len(levels) == 128 and np.abs(jz).max() == 2.890625
    g = torch.Generator().manual_seed(0)
    z = normal(g, (n,), torch.bfloat16, "cpu")
    assert z.dtype == torch.bfloat16
    zn = z.float().numpy()
    assert set(np.unique(zn)) <= set(levels)
    assert np.abs(zn).max() == 2.890625
    freq = np.unique(zn, return_counts=True)[1] / n
    p = 1 / 128
    assert np.abs(freq - p).max() <= 5 * np.sqrt(p * (1 - p) / n)
    assert abs(zn.var() - jz.var()) < 1e-2
    # a view in bf16 is drawn in bf16; f32 views keep torch.randn's
    noisy = make_noiser("normal", 0.5)
    v = noisy(g, torch.zeros(4096, dtype=torch.bfloat16))
    assert v.dtype == torch.bfloat16
    assert set(np.unique(v.float().numpy() / 0.5)) <= set(levels)
    assert len(np.unique(noisy(g, torch.zeros(4096)).numpy())) > 1000


def test_bf16_binom16_is_exact():
    """(popcount - 8) / 2 takes the same 17 values in bf16 as in f32."""
    g = torch.Generator().manual_seed(1)
    v = make_noiser("binom16", 1.0)(g, torch.zeros(1 << 16,
                                                   dtype=torch.bfloat16))
    assert v.dtype == torch.bfloat16
    assert set(v.float().unique().tolist()) <= {(k - 8) / 2
                                                for k in range(17)}


# ------------------------------------------------------------ the model

def test_bf16_products_carry_gradients_to_f32_params(rng):
    """As flax's ``dtype``: bf16 compute, f32 params, f32 gradients, and
    f32 logits and features."""
    params = init_basenet2_params(0, n_pc=N_PC, num_features=103,
                                  num_classes=9)
    model = BaseNet2(num_features=103, n_pc=N_PC, compute_dtype="bfloat16")
    model.load_state_dict(state_dict_from_jax(params))
    xp = torch.from_numpy(rng.normal(size=(4, W, W, N_PC)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(4, 103)).astype(np.float32))
    logits, feat = model(xp.to(torch.bfloat16), x.to(torch.bfloat16))
    assert logits.dtype == feat.dtype == torch.float32
    (logits.sum() + feat.sum()).backward()
    for name, p in model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        assert p.grad.abs().max() > 0, name


# ------------------------------------------------------------ 4-step parity

@pytest.fixture(scope="module", params=list(TRAINERS))
def parity(request, scenes):
    jscene, scene = scenes
    jcls, cls = TRAINERS[request.param]
    jt = jcls(JaxConfig(**TINY), donate=False)
    jstate = jt.init_state(jax.random.key(0))
    trainer = cls(CMLPLConfig(**TINY), device="cpu")
    state = trainer.state_from_jax(jax.device_get(jstate))
    splits = jax_generate_splits(jscene.labels, num_label=5)
    batches = list(JaxSampler(splits, jscene.labels, 8, 16, num_unlabel=64,
                              seed=3).epoch())
    jms, ms = [], []
    for (epoch, bi), (li, ly, ui) in zip(STEPS, batches):
        kw = dict(epoch=epoch, batch_index=bi) if request.param == "cmlpl" \
            else {}
        jstate, jm = jt.train_step(jstate, jscene, li, ly, ui, **kw)
        state, m = trainer.train_step(state, scene, li, ly, ui, **kw)
        jms.append({k: float(v) for k, v in jm.items()})
        ms.append({k: float(v) for k, v in m.items()})
    return dict(algo=request.param, jms=jms, ms=ms, trainer=trainer,
                state=state, jstate=jax.device_get(jstate))


def test_bf16_step_metrics_match_jax(parity):
    for i, (jm, m) in enumerate(zip(parity["jms"], parity["ms"])):
        assert set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(m[k], jm[k], err_msg=f"step {i} {k}",
                                       **LOSS_TOL)


def test_bf16_params_match_jax_after_4_steps(parity):
    algo, state, jstate = parity["algo"], parity["state"], parity["jstate"]
    got = parity["trainer"].state_to_jax(state)
    if algo == "cct":
        pairs, adams = [(got["params"], jstate.params)], 2
    else:
        pairs = [(got[n]["params"], getattr(jstate, n).params)
                 for n in ("net_b", "net_e")]
        adams = 1
    diffs = np.concatenate([
        np.abs(a - np.asarray(b)).ravel()
        for g_tree, j_tree in pairs
        for a, b in zip(jax.tree_util.tree_leaves(g_tree),
                        jax.tree_util.tree_leaves(j_tree))])
    assert diffs.max() <= 2 * 4 * adams * LR, diffs.max()
    assert np.quantile(diffs, 0.99) <= LR
    assert state.step == int(jstate.step) == 4


def test_cli_train_takes_bf16(tmp_path, capsys):
    acc_b, acc_e = cli_train.main([
        "--dataID", "0", "--n_PC", str(N_PC), "--num_epochs", "2",
        "--labeled_batch_size", "16", "--unlabeled_batch_size", "16",
        "--num_unlabel", "160", "--val_batch_size", "256", "--dropout", "0.5",
        "--device", "cpu", "--compute_dtype", "bfloat16",
        "--save_path_prefix", str(tmp_path), "--print_per_batches", "0"])
    assert "training time ==" in capsys.readouterr().out
    # the easy synthetic scene: both nets learn it in 2 epochs in bf16 too
    assert acc_b.oa > 0.9 and acc_e.oa > 0.9
