"""Faults planted in the zoo's DBDA, to show that the serving check of a
zoo cell catches a wrong model and not only a wrong label
(``calibrate_zoo.py`` on the card, ``tests/`` on the CPU).  None of them
is ever on in a benchmark run.

- ``no_cam``: the spectral branch's channel attention left out (its
  branch passes on unweighted).
- ``no_pam``: the spatial branch's position attention left out.
- ``bn_batch``: every BatchNorm normalises by the batch's statistics in
  evaluation, not by its running ones.
- ``no_gamma``: the attentions' ``gamma`` ignored (taken as 1).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FAULTS = ("no_cam", "no_pam", "bn_batch", "no_gamma")


def _left_out(self, x):
    return torch.ones_like(x)


def _batch_statistics(self, x):
    return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                        self.eps)


def _gamma_one(orig):
    def forward(self, x):
        saved = self.gamma
        self.gamma = torch.nn.Parameter(torch.ones_like(saved),
                                        requires_grad=False)
        try:
            return orig(self, x)
        finally:
            self.gamma = saved
    return forward


@contextlib.contextmanager
def planted(name: str):
    """The program with fault ``name`` inside the block."""
    from cmlpl_tpu_torch.models.attention import CAMModule, PAMModule
    from cmlpl_tpu_torch.models.common import BatchNorm

    if name == "no_cam":
        patches = [(CAMModule, "forward", _left_out)]
    elif name == "no_pam":
        patches = [(PAMModule, "forward", _left_out)]
    elif name == "bn_batch":
        patches = [(BatchNorm, "forward", _batch_statistics)]
    elif name == "no_gamma":
        patches = [(cls, "forward", _gamma_one(cls.forward))
                   for cls in (CAMModule, PAMModule)]
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
