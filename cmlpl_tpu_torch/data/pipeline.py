"""Epoch batching for semi-supervised training (``cmlpl_tpu/data/pipeline.py``).

The reference's ``HSIDataSet`` tiles the labeled set (45 samples) and the
unlabeled set up to ``max_iters`` samples so both DataLoaders yield the same
number of batches per epoch (``hsi_loader.py:29-45``), then zips them
(``train.py:149``).

Batches are **index arrays**, not tensors: the host sends int32 pixel ids
and the trainer gathers patches and spectra on the device.  One NumPy
generator, seeded once, draws every epoch's permutations, so one seed
yields the batches the JAX package yields.

Divergence from the reference (kept from the JAX package): the last partial
batch of each epoch (10000 % 128 = 16 samples) is dropped so every step has
the same shape: 78 instead of 79 steps per epoch at the defaults.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from cmlpl_tpu_torch.data.splits import Splits


def _tile_to(idx: np.ndarray, n: int) -> np.ndarray:
    """Tile ``idx`` to exactly ``n`` entries (reference hsi_loader.py:29-34)."""
    reps = n // len(idx)
    rem = n - reps * len(idx)
    return np.concatenate([np.tile(idx, reps), idx[:rem]])


class SemiSupervisedSampler:
    """Yields (labeled_idx, labeled_y, unlabeled_idx) batches per epoch."""

    def __init__(self, splits: Splits, labels: np.ndarray,
                 labeled_batch: int = 128, unlabeled_batch: int = 128,
                 num_unlabel: int = 10000, seed: int = 1088):
        self.labels = np.asarray(labels).reshape(-1)
        self.labeled_batch = labeled_batch
        self.unlabeled_batch = unlabeled_batch
        # reference truncates the unlabeled pool to num_unlabel
        # (hsi_loader.py:37) then tiles to max_iters = num_unlabel
        unl = splits.unlabeled[:num_unlabel]
        self._labeled = _tile_to(splits.train, num_unlabel)
        self._unlabeled = _tile_to(unl, num_unlabel)
        self._rng = np.random.default_rng(seed)

    @property
    def batches_per_epoch(self) -> int:
        return min(len(self._labeled) // self.labeled_batch,
                   len(self._unlabeled) // self.unlabeled_batch)

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        lab = self._rng.permutation(self._labeled)
        unl = self._rng.permutation(self._unlabeled)
        for b in range(self.batches_per_epoch):
            li = lab[b * self.labeled_batch:(b + 1) * self.labeled_batch]
            ui = unl[b * self.unlabeled_batch:(b + 1) * self.unlabeled_batch]
            # labels are 1-based with 0 = background; training uses 0-based
            # class ids (reference train.py:91 loads Y - 1)
            yield (li.astype(np.int32),
                   (self.labels[li] - 1).astype(np.int32),
                   ui.astype(np.int32))
