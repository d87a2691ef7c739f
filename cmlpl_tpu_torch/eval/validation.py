"""Per-class validation accuracy (``cmlpl_tpu/eval/validation.py``,
reference ``test_acc``, tools/hyper_tools.py:372-413).

Maps the scene once with the port's :class:`ScenePredictor` and reports
OA/AA and per-class accuracy over a labeled index set, printed in the
reference's format.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from cmlpl_tpu_torch.data.prep import PreparedScene
from cmlpl_tpu_torch.eval.inference import ScenePredictor


def validation_accuracy(model: Callable, scene: PreparedScene,
                        index: np.ndarray, *, patch_size: int,
                        num_classes: int, tile: int = 512, epoch: int = 0,
                        verbose: bool = True):
    """Evaluate ``model(xp, x) -> logits`` on the pixels in ``index`` and
    report per-class accuracy.  Returns (oa, aa, per_class)."""
    predictor = ScenePredictor(model, patch_size=patch_size,
                               cols=scene.cols, tile=min(tile, len(index)))
    preds = predictor(scene)[index]
    y = scene.labels[index] - 1

    per_class = np.zeros(num_classes)
    for c in range(num_classes):
        mask = y == c
        per_class[c] = (np.mean(preds[mask] == c) if mask.any() else 0.0)
    oa = float(np.mean(preds == y))
    aa = float(np.mean(per_class))
    if verbose:
        for c in range(num_classes):
            print(f"---------------Accuracy of {c:5d} : "
                  f"{per_class[c] * 100:.2f} %---------------")
        print(f"---------------Epoch[{epoch}]Validation-OA: "
              f"{oa * 100:.2f} %---------------")
        print(f"---------------Epoch[{epoch}]Validation-AA: "
              f"{aa * 100:.2f} %---------------")
    return oa, aa, per_class
