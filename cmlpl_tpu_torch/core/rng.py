"""Counter-based random draws that a traced program can carry
(``cmlpl_tpu/core/rng.py``, and the JAX package's key threading inside
its programs).

The eager trainers draw from a ``torch.Generator``.  A generator cannot
cross ``torch.export``, and Inductor's own ``rand`` seeds from the
process's global generator, so a draw inside an exported training run
must be a function of the run's inputs alone.  :class:`CounterStream` is
that function: the bits of a draw are threefry2x32 (20 rounds, the JAX
package's block function) of the run's key ``state.rng``, the step number
and the draw's index within the step.  Nothing is carried from step to
step but the key and the step.

Threefry needs only 32-bit add, rotate and xor.  They are done here in
int64 tensors holding values in [0, 2**32), masked after each add and
shift, so they export and lower as plain elementwise integer code (Philox
would need a 32x32 -> 64 multiply-high, which signed int64 gets wrong).

The samplers of ``ops/noise.py`` and ``models/common.keep_mask`` take a
*draw source*: a ``torch.Generator`` (the eager path, unchanged) or a
:class:`CounterStream`.  :func:`uniform` and :func:`integers` dispatch on it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block (20 rounds) of key (k0, k1) on counters
    (x0, x1): the JAX package's ``threefry2x32_p``.  Every argument is an
    int64 tensor (or int) of values in [0, 2**32); they broadcast.
    Returns the two output words as int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def seed_key(seed) -> np.ndarray:
    """A run's key, uint32 (2,), from ``seed`` (an int or a sequence of
    ints, as ``numpy.random.SeedSequence`` takes)."""
    return np.random.SeedSequence(seed).generate_state(2, np.uint32)


class CounterStream:
    """The draws of one training step: the k-th draw of the step
    (:meth:`bits`) is keyed by threefry2x32 of ``key`` on the counters
    (step, k), and its words are that key's blocks over (0..m, 0), both
    output words of each.  Draws are taken in the order the step makes
    them, as from a generator.

    ``key``: the run's key, (2,) of uint32 values in any integer dtype;
    ``step``: the step number, an int or a 0-d integer tensor."""

    def __init__(self, key: torch.Tensor, step):
        self.key = key.to(torch.int64)
        self.device = key.device
        self.step = torch.as_tensor(step, device=self.device).to(torch.int64)
        self._draws = 0

    def bits(self, n: int) -> torch.Tensor:
        """The next draw: ``n`` words in [0, 2**32) as an int64 (n,)."""
        k0, k1 = threefry2x32(self.key[0], self.key[1], self.step,
                              self._draws)
        self._draws += 1
        m = (n + 1) // 2
        x0 = torch.arange(m, device=self.device, dtype=torch.int64)
        y0, y1 = threefry2x32(k0, k1, x0, 0)
        return torch.cat([y0, y1])[:n]

    def words(self, shape) -> torch.Tensor:
        """The next draw as int64 words of ``shape``."""
        return self.bits(int(np.prod(shape, dtype=np.int64))).reshape(shape)


def uniform(source, shape, device) -> torch.Tensor:
    """U[0, 1) f32 of ``shape``: ``torch.rand`` from a generator, or a
    :class:`CounterStream` word's top 24 bits times 2**-24."""
    if isinstance(source, CounterStream):
        return (source.words(shape) >> 8).to(torch.float32) * 2.0 ** -24
    return torch.rand(shape, generator=source, device=device)


def integers(source, high: int, shape, device,
             dtype=torch.int64) -> torch.Tensor:
    """Uniform integers in [0, high) of ``shape``: ``torch.randint`` from a
    generator, or ``(word * high) >> 32`` of a :class:`CounterStream`
    (a power-of-two ``high`` takes a word's top bits)."""
    if isinstance(source, CounterStream):
        return ((source.words(shape) * high) >> 32).to(dtype)
    return torch.randint(0, high, shape, generator=source, device=device,
                         dtype=dtype)


def normal_f32(stream: CounterStream, shape) -> torch.Tensor:
    """Standard normal f32 of ``shape`` from a :class:`CounterStream`:
    ``sqrt(2) * erfinv(v)`` for v = (2k + 1 - 2**24) / 2**24, k a word's top
    24 bits, so v lies in (-1, 1), symmetric, and is exact in f32."""
    k = stream.words(shape) >> 8
    v = (2 * k + 1 - (1 << 24)).to(torch.float32) * 2.0 ** -24
    return torch.erfinv(v) * math.sqrt(2.0)
