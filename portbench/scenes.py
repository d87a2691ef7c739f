"""The benchmark's inputs, made from ``--seed``: scenes, label splits,
schedules and initial weights.

Every generator takes its own stream, spawned from the run's seed by
:func:`streams`, so the same seed gives the same inputs whatever else a
run draws.  Cubes and weights are made on the device with a
``torch.Generator`` in a few large calls; the host draws only small
integer arrays (splits and schedules) with NumPy.  The program and the
plain reference are handed the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def streams(seed: int, n: int) -> list[np.random.SeedSequence]:
    """``n`` independent streams of ``seed`` (any whole number >= 0)."""
    return np.random.SeedSequence(int(seed)).spawn(n)


def seed_int(stream: np.random.SeedSequence) -> int:
    """A 63-bit seed for a ``torch.Generator`` from ``stream``."""
    return int(stream.generate_state(2, np.uint64)[0] >> np.uint64(1))


def make_scene(stream, rows: int, cols: int, bands: int, classes: int,
               device) -> tuple[torch.Tensor, torch.Tensor]:
    """A synthetic (rows, cols, bands) f32 cube and its (rows, cols) int64
    ground truth (classes 1..C, 0 for the quarter of pixels left
    unlabeled), on ``device``.

    Classes lie in spatially coherent blobs (the nearest of 6 C random
    centres); each class has a smooth signature (4 random sinusoids over
    the bands plus an offset), scaled per pixel by a brightness in
    [0.8, 1.2] and perturbed by Gaussian noise of 0.08 times the
    signatures' spread, as a radiance cube with real structure."""
    g = torch.Generator(device).manual_seed(seed_int(stream))
    blobs = 6 * classes
    centres = torch.rand(blobs, 2, generator=g, device=device) * torch.tensor(
        [rows, cols], dtype=torch.float32, device=device)
    # every class owns 6 blobs
    blob_cls = torch.randperm(blobs, generator=g, device=device) % classes
    rr = torch.arange(rows, device=device, dtype=torch.float32)
    cc = torch.arange(cols, device=device, dtype=torch.float32)
    d2 = ((rr[:, None, None] - centres[:, 0]) ** 2
          + (cc[None, :, None] - centres[:, 1]) ** 2)
    cls = blob_cls[d2.argmin(-1)]                                 # (r, c)
    wl = torch.linspace(0, 1, bands, device=device)
    amp, freq, phase = (torch.rand(3, classes, 4, 1, generator=g,
                                   device=device))
    sigs = (((0.3 + 0.7 * amp) * torch.sin(
        2 * torch.pi * (1 + 7 * freq) * wl + 2 * torch.pi * phase))
            .sum(1) + 2 + 4 * torch.rand(classes, 1, generator=g,
                                         device=device))       # (C, bands)
    bright = 0.8 + 0.4 * torch.rand(rows, cols, 1, generator=g,
                                    device=device)
    noise = torch.randn(rows, cols, bands, generator=g, device=device)
    cube = sigs[cls] * bright + 0.08 * sigs.std() * noise
    unlabeled = torch.rand(rows, cols, generator=g, device=device) < 0.25
    gt = torch.where(unlabeled, 0, cls + 1)
    return cube.float(), gt.long()


def make_splits(stream, gt: np.ndarray, num_label: int,
                num_unlabel: int) -> tuple[np.ndarray, np.ndarray]:
    """(train ids, unlabeled ids) of the flat ground truth ``gt``:
    ``num_label`` pixels of each class drawn without replacement, and
    ``num_unlabel`` other labeled pixels (the reference's recipe,
    ``sample_generation.py:43-65``: the unlabeled pool is the labeled
    pixels that are not training pixels, shuffled)."""
    rng = np.random.default_rng(stream)
    gt = np.asarray(gt).reshape(-1)
    train = np.concatenate([
        rng.choice(np.flatnonzero(gt == c), num_label, replace=False)
        for c in range(1, int(gt.max()) + 1)])
    rest = np.setdiff1d(np.flatnonzero(gt > 0), train)
    unl = rng.permutation(rest)[:num_unlabel]
    if len(unl) < num_unlabel:
        raise ValueError(f"{len(unl)} unlabeled pixels, want {num_unlabel}")
    return train.astype(np.int64), unl.astype(np.int64)


def _tile_to(idx: np.ndarray, n: int) -> np.ndarray:
    reps, rem = divmod(n, len(idx))
    return np.concatenate([np.tile(idx, reps), idx[:rem]])


def semi_epochs(stream, train, unlabeled, gt, *, epochs: int,
                labeled_batch: int, unlabeled_batch: int,
                num_unlabel: int):
    """One seed's semi-supervised schedule, ``epochs`` epochs of
    (labeled ids, labeled 0-based classes, unlabeled ids), each (E, N, B)
    int32: the labeled and unlabeled sets tiled to ``num_unlabel``,
    permuted each epoch and cut into N whole batches (the reference's
    ``HSIDataSet``, ``hsi_loader.py:29-45``, with the last partial batch
    dropped)."""
    rng = np.random.default_rng(stream)
    gt = np.asarray(gt).reshape(-1)
    lab = _tile_to(np.asarray(train), num_unlabel)
    unl = _tile_to(np.asarray(unlabeled)[:num_unlabel], num_unlabel)
    n = min(len(lab) // labeled_batch, len(unl) // unlabeled_batch)
    li, ui = [], []
    for _ in range(epochs):
        li.append(rng.permutation(lab)[:n * labeled_batch]
                  .reshape(n, labeled_batch))
        ui.append(rng.permutation(unl)[:n * unlabeled_batch]
                  .reshape(n, unlabeled_batch))
    li, ui = np.stack(li).astype(np.int32), np.stack(ui).astype(np.int32)
    return li, (gt[li] - 1).astype(np.int32), ui


def supervised_steps(stream, train, gt, *, steps: int, batch: int):
    """A supervised run of ``steps`` one-batch epochs over the training
    ids: each a fresh permutation cut to ``batch`` (the split tiled when
    it is smaller).  Returns (ids, 0-based classes), each (T, B) int32."""
    rng = np.random.default_rng(stream)
    gt = np.asarray(gt).reshape(-1)
    train = np.asarray(train)
    ids = np.stack([_tile_to(rng.permutation(train), batch)[:batch]
                    for _ in range(steps)]).astype(np.int32)
    return ids, (gt[ids] - 1).astype(np.int32)


# --------------------------------------------------------------------------
# Initial weights, in the torch layout of the plain references' parameter
# names, made on the device in one call per batch of models
# --------------------------------------------------------------------------

def _uniform_models(stream, shapes: dict, count: int, bound, device):
    """``count`` state dicts of the ``shapes`` (name -> shape), each leaf
    uniform in (-b, b) for b = ``bound(name, shape)`` (0: the leaf is
    zero), drawn as ONE uniform tensor on ``device``."""
    g = torch.Generator(device).manual_seed(seed_int(stream))
    sizes = [int(np.prod(s)) for s in shapes.values()]
    flat = torch.rand(count, sum(sizes), generator=g, device=device) * 2 - 1
    out = []
    for k in range(count):
        sd, off = {}, 0
        for (name, shape), size in zip(shapes.items(), sizes):
            b = bound(name, shape)
            sd[name] = (flat[k, off:off + size] * b).reshape(shape).clone()
            off += size
        out.append(sd)
    return out


def _fan_in(shape) -> int:
    return int(np.prod(shape[1:]))


def basenet2_weights(stream, shapes: dict, count: int, device) -> list:
    """``count`` BaseNet2 state dicts with torch's default bounds
    (weight and bias uniform in +-1/sqrt(fan_in))."""
    def bound(name, shape):
        w = shapes[name.rsplit(".", 1)[0] + ".weight"]
        return 1.0 / np.sqrt(_fan_in(w))

    return _uniform_models(stream, shapes, count, bound, device)


def lecun_weights(stream, shapes: dict, count: int, device) -> list:
    """``count`` state dicts of a BatchNorm network: kernels uniform at
    LeCun's variance (bound sqrt(3/fan_in)), biases 0, norm scales 1,
    running means 0 and variances 1."""
    def bound(name, shape):
        return np.sqrt(3.0 / _fan_in(shape)) if len(shape) > 1 else 0.0

    sds = _uniform_models(stream, shapes, count, bound, device)
    for sd in sds:
        for name, t in sd.items():
            if name.endswith("running_var") or (
                    name.endswith("weight") and t.dim() == 1):
                t.fill_(1.0)
    return sds
