"""Few-shot label split generation — byte-identical to the reference.

Reproduces ``sample_generation.py:43-65`` exactly (including the legacy
NumPy global-RNG calls), because the split arrays are the de-facto
regression fixture of the reference: a known-good OA (94.36 on PaviaU,
``sample_generation.py:47``) is tied to seed 2 / seed 0 splits.

Algorithm:
  1. seed(2); shuffle the indices of all labeled (Y > 0) pixels
     -> candidate pool for the unlabeled set.
  2. per class i (1-based): seed(0); permute the class's pixel indices;
     first ``num_label`` -> train, rest -> test.
  3. unlabeled = set(pool) - set(train), materialised via Python set
     iteration exactly as the reference does (int hashing makes this
     deterministic).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass(frozen=True)
class Splits:
    train: np.ndarray     # (num_classes * num_label,) flat pixel indices
    test: np.ndarray      # remaining labeled pixels
    unlabeled: np.ndarray  # shuffled labeled-pixel pool minus train


def generate_splits(labels: np.ndarray, num_label: int = 5,
                    whole_seed: int = 2, class_seed: int = 0) -> Splits:
    """``labels`` is the flat 1-based ground truth (0 = background)."""
    Y = np.asarray(labels).reshape(-1)
    n_class = int(Y.max())

    np.random.seed(whole_seed)
    pool = np.where(Y > 0)[0]
    np.random.shuffle(pool)

    train_parts, test_parts = [], []
    for i in range(1, n_class + 1):
        index = np.where(Y == i)[0]
        np.random.seed(class_seed)
        perm = np.random.permutation(index.shape[0])
        train_parts.append(index[perm[:num_label]])
        test_parts.append(index[perm[num_label:]])
    train = np.concatenate(train_parts)
    test = np.concatenate(test_parts)

    # Reference: np.array(list(set(pool) - set(train)))
    # (sample_generation.py:65).  Python int hashing makes the iteration
    # order deterministic for identical contents.
    unlabeled = np.array(list(set(pool) - set(train)))
    return Splits(train=train, test=test, unlabeled=unlabeled)


def load_splits(split_dir: str) -> Splits:
    """Load the reference's materialised split arrays
    (``train_array.npy`` / ``test_array.npy`` / ``unlabel_array.npy``,
    the files ``sample_generation.py:68-73`` writes), so a user can bring
    an existing reference ``dataset/<name>/`` directory, hand-edited or
    non-default splits included, instead of regenerating them."""

    def arr(name):
        return np.load(os.path.join(split_dir, name)).reshape(-1)

    return Splits(train=arr("train_array.npy"),
                  test=arr("test_array.npy"),
                  unlabeled=arr("unlabel_array.npy"))

