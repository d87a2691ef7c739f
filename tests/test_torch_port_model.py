"""The port's BaseNet2 vs the flax BaseNet2 on the same weights, and the
weight interchange (JAX-layout npz) between the two packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmlpl_tpu.models import BaseNet2 as JaxBaseNet2
from cmlpl_tpu_torch.models.basenet import BaseNet2
from cmlpl_tpu_torch.models.common import avg_pool2, l2_normalize
from cmlpl_tpu_torch.weights import (basenet2_state_dict_from_jax,
                                     init_basenet2_params, load_params_npz,
                                     save_params_npz)
from torch_port_threads import one_torch_thread  # noqa: F401

W, N_PC, BANDS, NCLS = 20, 16, 103, 9


def _flax_params(seed=0):
    model = JaxBaseNet2(num_features=BANDS, num_classes=NCLS, n_pc=N_PC)
    params = model.init(jax.random.key(seed), jnp.zeros((1, W, W, N_PC)),
                        jnp.zeros((1, BANDS)), train=False)["params"]
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def _inputs(rng, b=6):
    xp = rng.normal(size=(b, W, W, N_PC)).astype(np.float32)
    x = rng.normal(size=(b, BANDS)).astype(np.float32)
    return xp, x


def _both(params, xp, x, compute_dtype):
    dt = {"float32": None, "bfloat16": jnp.bfloat16}[compute_dtype]
    jmodel = JaxBaseNet2(num_features=BANDS, num_classes=NCLS, n_pc=N_PC,
                         dtype=dt)
    want = jmodel.apply({"params": params}, jnp.asarray(xp), jnp.asarray(x),
                        train=False)
    model = BaseNet2(num_features=BANDS, num_classes=NCLS, n_pc=N_PC,
                     patch_size=W, compute_dtype=compute_dtype).eval()
    model.load_state_dict(basenet2_state_dict_from_jax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(xp), torch.from_numpy(x))
    return [g.numpy() for g in got], [np.asarray(v) for v in want]


def test_basenet2_f32_matches_flax(rng):
    """The tolerance of tests/test_torch_parity.py: f32 conv sums taken in
    another order by XLA:CPU and oneDNN."""
    (logits, feat), (jlogits, jfeat) = _both(_flax_params(), *_inputs(rng),
                                             "float32")
    assert logits.dtype == feat.dtype == np.float32
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(feat, jfeat, rtol=1e-4, atol=1e-5)


def test_basenet2_bf16_matches_flax(rng):
    """bf16 compute: both frameworks round every layer's output to bf16
    (8-bit mantissa) but at different points inside a conv or a dense.
    The logits (|logit| < 1) then differ by a bf16 step or two, at most
    2**-8 = 3.9e-3 each: atol 1e-2.  The feature (|feat| < 0.25) is
    l2-normalised in f32 from the bf16 spectral output: atol 2e-3."""
    (logits, feat), (jlogits, jfeat) = _both(_flax_params(), *_inputs(rng),
                                             "bfloat16")
    assert logits.dtype == feat.dtype == np.float32
    np.testing.assert_allclose(logits, jlogits, rtol=0, atol=1e-2)
    np.testing.assert_allclose(feat, jfeat, rtol=0, atol=2e-3)


def test_flatten_order_is_hwc(rng):
    """The classifier's spatial rows are in (H, W, C) order: a weight on
    one spatial row reaches the logit only if the permute is right."""
    params = _flax_params()
    params["classifier"]["kernel"] = np.zeros_like(
        params["classifier"]["kernel"])
    params["classifier"]["kernel"][7, 0] = 1.0   # (h=0, w=0, c=7)
    (logits, _), (jlogits, _) = _both(params, *_inputs(rng), "float32")
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-5)
    assert np.abs(jlogits[:, 0]).max() > 0


def test_npz_round_trip(tmp_path, rng):
    params = init_basenet2_params(3, n_pc=N_PC, num_features=BANDS,
                                  num_classes=NCLS, patch_size=W)
    # the tree has the flax model's structure, shapes and dtypes
    ref = _flax_params()
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(ref)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves_with_path(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    # torch-default init bounds
    for name in ("conv1", "classifier"):
        fan_in = int(np.prod(params[name]["kernel"].shape[:-1]))
        assert np.abs(params[name]["kernel"]).max() <= 1 / np.sqrt(fan_in)

    path = str(tmp_path / "w.npz")
    save_params_npz(path, params)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            f"{k}/{leaf}" for k in params for leaf in ("kernel", "bias"))
    back = load_params_npz(path)
    for name in params:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back[name][leaf],
                                          params[name][leaf])
    (logits, _), (jlogits, _) = _both(back, *_inputs(rng), "float32")
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-5)


def test_common_blocks(rng):
    from cmlpl_tpu.models.common import avg_pool2 as jax_avg_pool2
    from cmlpl_tpu.models.common import l2_normalize as jax_l2_normalize

    x = rng.normal(size=(3, 9)).astype(np.float32)
    np.testing.assert_allclose(l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_l2_normalize(jnp.asarray(x))),
                               rtol=1e-6)
    # no eps: a zero row divides by zero, as in the reference
    assert torch.isnan(l2_normalize(torch.zeros(1, 4))).all()
    h = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)   # odd: floor mode
    got = avg_pool2(torch.from_numpy(h).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jax_avg_pool2(jnp.asarray(h))),
                               rtol=1e-6)


def test_tf32_follows_compute_dtype(rng, monkeypatch):
    """Inside a model's convolutions the TF32 switches follow its compute
    dtype (on under bf16, off under f32); building and running a bf16 then
    an f32 model leaves the process's switches as they were, whatever
    they were."""
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append(tuple(f.allow_tf32 for f in flags))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    xp, x = (torch.from_numpy(a[:2]) for a in _inputs(rng))
    saved = tuple(f.allow_tf32 for f in flags)
    try:
        for before in ((True, False), (False, True)):
            for f, v in zip(flags, before):
                f.allow_tf32 = v
            for dtype, tf32 in (("bfloat16", True), ("float32", False)):
                seen.clear()
                model = BaseNet2(num_features=BANDS, n_pc=N_PC,
                                 compute_dtype=dtype)
                assert tuple(f.allow_tf32 for f in flags) == before
                model(xp, x)
                assert seen == [(tf32, tf32)] * 3
                assert tuple(f.allow_tf32 for f in flags) == before
        with pytest.raises(ValueError):
            BaseNet2(n_pc=N_PC, compute_dtype="float16")
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
