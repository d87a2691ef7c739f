"""Run reporting (``cmlpl_tpu/eval/report.py``, reference ``train.py:324-353``):
OA/AA/Kappa and per-class accuracy, mean ± std over repeated runs, as one
CSV.  Written with the ``csv`` module, with the columns, rows and values of
the JAX package's pandas table: one row per class, the scalar columns
repeated on every row."""

from __future__ import annotations

import csv
from typing import Sequence

import numpy as np

from cmlpl_tpu_torch.eval.metrics import Accuracy


def results_columns(runs: Sequence[Accuracy], prefix: str = "") -> dict:
    """The reference's result table (train.py:342-343) for one network's
    repeated runs: column name -> (num_classes,) values."""
    oa = np.array([r.oa for r in runs]) * 100
    aa = np.array([r.aa for r in runs]) * 100
    kappa = np.array([r.kappa for r in runs]) * 100
    producer = np.stack([r.producer for r in runs]) * 100
    n = producer.shape[1]
    cols = {}
    for name, v in (("OA", oa), ("AA", aa), ("KAPPA", kappa)):
        cols[f"{prefix}{name}"] = np.full(n, np.mean(v))
        cols[f"{prefix}{name}_std"] = np.full(n, np.std(v))
    cols[f"{prefix}ALL_ACC"] = np.mean(producer, axis=0)
    cols[f"{prefix}ALL_ACC_std"] = np.std(producer, axis=0)
    return cols


def save_report(path: str, runs_b: Sequence[Accuracy],
                runs_e: Sequence[Accuracy] | None = None) -> None:
    cols = results_columns(runs_b)
    if runs_e:
        cols.update(results_columns(runs_e, prefix="net_e_"))
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(cols)
        out.writerows(zip(*(map(float, v) for v in cols.values())))
