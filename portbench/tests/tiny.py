"""Each cell of ``BENCHMARK.json`` at a size the CPU runs in seconds:
the same drivers, references and checks, on a 64 x 48 scene (the
port's synthetic dataset 0) with small batches, few seeds and, for
BaseNet2, 8 PCA channels and 8 x 8 patches."""

from __future__ import annotations

import dataclasses

from portbench import registry

TINY = {
    "cmlpl-fused12-paviau": {
        "dataset_id": 0, "rows": 64, "cols": 48, "n_pc": 8, "patch_size": 8,
        "num_unlabel": 64, "labeled_batch": 8, "unlabeled_batch": 8,
        "num_epochs": 5, "seeds": 2},
    "serve-paviau": {
        "dataset_id": 0, "rows": 64, "cols": 48, "n_pc": 8, "patch_size": 8,
        "serve_tile": 256, "cubes": 2, "checked_requests": 2},
    "ssrn-train-paviau": {
        "dataset_id": 0, "rows": 64, "cols": 48, "num_label": 2,
        "batch": 18, "num_epochs": 4, "prepared_runs": 3},
}


def cell(name: str) -> registry.Cell:
    """The cell ``name`` of the checkout's ``BENCHMARK.json`` with the
    tiny sizes in its configuration and traffic."""
    c = registry.cell(name)
    tiny = TINY[name]
    return dataclasses.replace(
        c, config={**c.config, **{k: v for k, v in tiny.items()
                                  if k in c.config}},
        traffic={**c.traffic, **{k: v for k, v in tiny.items()
                                 if k not in c.config}})
