"""The counter-based draws of an exported training run
(``cmlpl_tpu_torch/core/rng.py``), the samplers' draw sources, the
functional Adam and the out-of-place queue write
(``cmlpl_tpu_torch/train/functional.py``, ``objectives/queue.py``).

- threefry2x32 is the JAX package's block function, bit for bit, on a
  grid of keys and counters (``jax._src.prng.threefry2x32_p``).
- The draws hold by distribution (the eager generator's bits are Philox's,
  not threefry's): uniform and normal moments, the bf16 normal's 128
  levels and their frequencies, the keep rate of dropout masks, and they
  depend on the key, the step and the draw's index alone.
- A generator source draws exactly as before (``torch.rand``,
  ``torch.randint``).
- ``adam_update`` equals ``torch.optim.Adam`` bit for bit over 1,300
  steps (step 1,270 is one where ``sqrt`` and ``** 0.5`` of the bias
  correction round apart).
"""

import jax
import numpy as np
import pytest
import torch
from jax._src import prng

from cmlpl_tpu_torch.core.rng import (CounterStream, integers, normal_f32,
                                      seed_key, threefry2x32, uniform)
from cmlpl_tpu_torch.models.common import keep_mask
from cmlpl_tpu_torch.objectives.queue import (QueueState, queue_update,
                                              queue_write)
from cmlpl_tpu_torch.ops.noise import (_bf16_normal_levels, make_noiser,
                                       masked_choice, normal)
from cmlpl_tpu_torch.train.functional import adam_hyper, adam_update

from torch_port_threads import one_torch_thread  # noqa: F401

N = 1 << 16


def stream(key=(1, 2), step=0):
    return CounterStream(torch.tensor(key, dtype=torch.int64), step)


@pytest.mark.parametrize("key", [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF),
                                 (0x12345678, 0x9ABCDEF0), (7, 1 << 31)],
                         ids=["zero", "ones", "mixed", "high_bit"])
def test_threefry_block_equals_jax(key):
    rng = np.random.default_rng(sum(key) % 1000)
    x = rng.integers(0, 2 ** 32, (2, 4096), dtype=np.uint64).astype(
        np.uint32)
    x[:, :3] = [[0, 0xFFFFFFFF, 1], [0, 0xFFFFFFFF, 0]]
    want = prng.threefry2x32_p.bind(np.uint32(key[0]), np.uint32(key[1]),
                                    x[0], x[1])
    got = threefry2x32(torch.tensor(key[0]), torch.tensor(key[1]),
                       *(torch.from_numpy(a.astype(np.int64)) for a in x))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      g.numpy())


def test_threefry_of_jax_split_keys():
    """The block under JAX's own key derivation: ``random.split`` of a
    threefry key into 2 is the block of the key on the counters (0, 0),
    (0, 1) (``threefry_partitionable``) or (0, 1), (2, 3)."""
    key = jax.random.key_data(jax.random.key(1088))
    split = np.asarray(jax.random.key_data(
        jax.random.split(jax.random.wrap_key_data(key), 2)))
    k = (torch.tensor(int(v)) for v in np.asarray(key))
    if jax.config.jax_threefry_partitionable:
        y0, y1 = threefry2x32(*k, torch.tensor([0, 0]), torch.tensor([0, 1]))
        want = torch.stack([y0, y1], dim=-1)
    else:
        y0, y1 = threefry2x32(*k, torch.tensor([0, 1]), torch.tensor([2, 3]))
        want = torch.cat([y0, y1]).reshape(2, 2)
    np.testing.assert_array_equal(split, want.numpy())


def test_draws_are_a_function_of_key_step_and_index():
    a = stream().bits(1000)
    np.testing.assert_array_equal(a.numpy(), stream().bits(1000).numpy())
    assert ((a >= 0) & (a < 2 ** 32)).all()
    s = stream()
    first, second = s.bits(1000), s.bits(1000)
    for other in (stream(key=(1, 3)).bits(1000), stream(step=1).bits(1000),
                  second):
        assert (other != first).float().mean() > 0.99
    # a longer draw starts with the shorter one's words only in its first
    # half (the halves are the block's two outputs)
    assert torch.equal(stream().bits(999)[:499], first[:499])


def test_uniform_and_integers():
    u = uniform(stream(), (N,), "cpu")
    assert u.dtype == torch.float32 and 0 <= u.min() and u.max() < 1
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert abs(float(u.var()) - 1 / 12) < 0.005
    # 24-bit lattice: every value times 2**24 is an integer
    assert torch.equal(u * 2 ** 24, torch.floor(u * 2 ** 24))
    k = integers(stream(), 4, (N,), "cpu")
    counts = torch.bincount(k, minlength=4).float() / N
    assert k.min() == 0 and k.max() == 3
    assert torch.allclose(counts, torch.full((4,), 0.25), atol=0.01)


def test_normal_moments():
    z = normal_f32(stream(), (N,)).double()
    assert torch.isfinite(z).all()
    assert abs(float(z.mean())) < 0.02
    assert abs(float(z.var()) - 1) < 0.03
    kurt = float(((z - z.mean()) ** 4).mean() / z.var() ** 2)
    assert abs(kurt - 3) < 0.15
    # symmetric lattice: v and -v equally likely, so the median is ~0
    assert abs(float(z.median())) < 0.02
    assert torch.equal(normal(stream(), (N,), torch.float32, "cpu"),
                       normal_f32(stream(), (N,)))


def test_bf16_normal_takes_jax_levels():
    z = normal(stream(), (N,), torch.bfloat16, "cpu")
    levels = _bf16_normal_levels(torch.device("cpu"))
    assert z.dtype == torch.bfloat16
    values, counts = torch.unique(z, return_counts=True)
    assert torch.equal(values, torch.unique(levels))
    # 128 equally likely levels (one value may be two levels)
    per_level = torch.tensor([int((levels == v).sum()) for v in values])
    freq = counts.double() / N / per_level
    assert torch.allclose(freq, torch.full_like(freq, 1 / 128),
                          rtol=0.15)
    want = jax.random.normal(jax.random.key(0), (N,), jax.numpy.bfloat16)
    assert set(np.unique(np.asarray(want, np.float32))) == set(
        values.float().numpy())


@pytest.mark.parametrize("rate", [0.5, 0.8])
def test_keep_mask_rate(rate):
    keep = keep_mask((256, 2624), rate, stream(), "cpu")
    assert keep.dtype == torch.bool
    assert abs(float(keep.float().mean()) - (1 - rate)) < 0.005


def test_binom16_and_masked_choice():
    noisy = make_noiser("binom16", 1.0)
    v = noisy.sample(stream(), (N,), torch.float32, "cpu")
    assert set(torch.unique(v * 2).tolist()) <= set(range(-16, 17))
    assert abs(float(v.mean())) < 0.02 and abs(float(v.var()) - 1) < 0.03
    mask = torch.rand((64, 50), generator=torch.Generator().manual_seed(0)
                      ) < 0.3
    mask[:, 7] = True
    pick = masked_choice(stream(), mask, 20)
    assert pick.shape == (64, 20)
    assert mask.gather(1, pick).all()


def test_a_generator_draws_as_before():
    def gen():
        return torch.Generator().manual_seed(5)

    assert torch.equal(uniform(gen(), (100,), "cpu"),
                       torch.rand((100,), generator=gen()))
    assert torch.equal(integers(gen(), 128, (100,), "cpu"),
                       torch.randint(0, 128, (100,), generator=gen()))
    assert torch.equal(keep_mask((10, 10), 0.8, gen(), "cpu"),
                       torch.rand((10, 10), generator=gen()) < 0.2)


def test_seed_key():
    k = seed_key((1088, 0))
    assert k.dtype == np.uint32 and k.shape == (2,)
    np.testing.assert_array_equal(k, seed_key((1088, 0)))
    assert not np.array_equal(k, seed_key((1088, 1)))


def test_adam_update_equals_torch_adam():
    gen = torch.Generator().manual_seed(0)
    p = torch.randn(37, generator=gen)
    q = p.clone().requires_grad_(True)
    opt = torch.optim.Adam([q], lr=5e-4)
    params = {"w": p}
    state = {"count": torch.zeros((), dtype=torch.int32),
             "mu": {"w": torch.zeros(37)}, "nu": {"w": torch.zeros(37)}}
    for _ in range(1300):
        g = torch.randn(37, generator=gen) * 1e-3
        q.grad = g.clone()
        opt.step()
        params, state = adam_update(params, {"w": g}, state, ["w"],
                                    adam_hyper(opt))
    assert int(state["count"]) == 1300
    assert torch.equal(params["w"], q.detach())
    assert torch.equal(state["mu"]["w"], opt.state[q]["exp_avg"])
    assert torch.equal(state["nu"]["w"], opt.state[q]["exp_avg_sq"])


def test_adam_hyper_refuses_what_it_cannot_replay():
    w = torch.zeros(2, requires_grad=True)
    with pytest.raises(ValueError, match="plain Adam"):
        adam_hyper(torch.optim.Adam([w], weight_decay=0.1))


@pytest.mark.parametrize("ptr", [0, 120, 150], ids=["start", "end", "wrap"])
def test_queue_write_equals_queue_update(ptr):
    gen = torch.Generator().manual_seed(ptr)
    feats, probs = torch.randn(160, 8, generator=gen), torch.rand(
        160, 3, generator=gen)
    rows = torch.randn(32, 8, generator=gen), torch.rand(32, 3,
                                                         generator=gen)
    eager = QueueState(feats.clone(), probs.clone(), ptr)
    queue_update(eager, *rows)
    out = queue_write(QueueState(feats, probs, torch.tensor(
        ptr, dtype=torch.int32)), *rows)
    assert torch.equal(out.feats, eager.feats)
    assert torch.equal(out.probs, eager.probs)
    assert int(out.ptr) == eager.ptr and out.ptr.dtype == torch.int32
