"""Accuracy metrics (reference ``tools/hyper_tools.py:208-223``).

OA, Cohen's Kappa and per-class producer accuracy, with the same Kappa
formula: (n * sum(correct) - sum(real_i * pred_i)) / (n^2 - sum(real_i * pred_i)).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Accuracy(NamedTuple):
    oa: float
    aa: float
    kappa: float
    producer: np.ndarray  # per-class producer accuracy


def cal_accuracy(predict: np.ndarray, label: np.ndarray) -> Accuracy:
    """``predict``/``label`` are 0-based class ids over the test pixels."""
    predict = np.asarray(predict).reshape(-1)
    label = np.asarray(label).reshape(-1)
    n = label.shape[0]
    oa = float(np.sum(predict == label)) / n

    num = int(label.max()) + 1
    correct = np.zeros(num)
    real = np.zeros(num)
    pred = np.zeros(num)
    producer = np.zeros(num)
    for i in range(num):
        correct[i] = np.sum(label[predict == i] == i)
        real[i] = np.sum(label == i)
        pred[i] = np.sum(predict == i)
        producer[i] = correct[i] / real[i] if real[i] > 0 else 0.0

    cross = np.sum(real * pred)
    kappa = (n * np.sum(correct) - cross) / (n * n - cross)
    return Accuracy(oa=oa, aa=float(np.mean(producer)), kappa=float(kappa),
                    producer=producer)
