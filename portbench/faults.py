"""Faults planted in the program, to show that the check catches them
(``calibrate.py`` on the card, ``tests/`` on the CPU).  None of them is
ever on in a benchmark run.

- ``unchanged``: every optimizer step leaves the state as it was.
- ``half``: each training step drops half of its labeled and half of its
  unlabeled rows and takes its losses' means over the rest.
- ``altered``: each served map has its first pixel's label changed.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half", "altered")


def _half_losses(orig):
    def _losses(self, apply, d, lab_y, carry, epoch, batch_index, thr=None):
        bt = lab_y.shape[0]
        n = d["xp_b"].shape[0]
        keep = torch.cat([torch.arange(bt // 2),
                          torch.arange(bt, bt + (n - bt) // 2)]).to(
            lab_y.device)
        d = {k: v.index_select(0, keep) if v.shape[0] == n else v
             for k, v in d.items()}
        return orig(self, apply, d, lab_y[:bt // 2], carry, epoch,
                    batch_index, thr)
    return _losses


def _half_step(orig):
    def _step(self, state, xp, x, y):
        h = y.shape[0] // 2
        return orig(self, state, xp[:h], x[:h], y[:h])
    return _step


def _altered(orig, classes: int):
    def __call__(self, scene):
        out = orig(self, scene).copy()
        out[0] = (out[0] + 1) % classes
        return out
    return __call__


@contextlib.contextmanager
def planted(name: str, classes: int = 9):
    """The program with fault ``name`` inside the block."""
    from cmlpl_tpu_torch.eval.inference import ScenePredictor
    from cmlpl_tpu_torch.train.cmlpl import CMLPLTrainer
    from cmlpl_tpu_torch.train.supervised import SupervisedTrainer

    if name == "unchanged":
        patches = [(torch.optim.Adam, "step",
                    lambda self, closure=None: None)]
    elif name == "half":
        patches = [(CMLPLTrainer, "_losses",
                    _half_losses(CMLPLTrainer._losses)),
                   (SupervisedTrainer, "_step",
                    _half_step(SupervisedTrainer._step))]
    elif name == "altered":
        patches = [(ScenePredictor, "__call__",
                    _altered(ScenePredictor.__call__, classes))]
    else:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    saved = [(cls, attr, cls.__dict__[attr]) for cls, attr, _ in patches]
    try:
        for cls, attr, fn in patches:
            setattr(cls, attr, fn)
        yield
    finally:
        for cls, attr, fn in saved:
            setattr(cls, attr, fn)
