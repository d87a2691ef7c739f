"""The comparison-model zoo (``cmlpl_tpu/models/zoo.py``; reference
``tools/conpared_models.py``): model names to constructors and input
signatures, so the supervised trainer and the scene map can drive any
backbone; plus the zoo's ``BaseNet2Zoo``, the EMA-teacher update and the
style randomisations.

A zoo model's ``forward`` takes ``(xp, x, generator=None)`` for a "dual"
entry (patch and spectrum) and ``(xp, generator=None)`` for a "patch"
one; ``generator`` draws the dropout masks in training mode.  Unlike
flax, torch sizes every layer when it is built, so :func:`build_model`
takes the patch size too.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from cmlpl_tpu_torch.core import tp as tpc
from cmlpl_tpu_torch.device import compute_precision
from cmlpl_tpu_torch.models.basenet import (BaseNet1, BaseNet2, _Stem,
                                            joint_dim)
from cmlpl_tpu_torch.models.common import dropout, l2_normalize
from cmlpl_tpu_torch.models.dbda import DBDA, DBDAFeature
from cmlpl_tpu_torch.models.fdssc import FDSSC
from cmlpl_tpu_torch.models.msvit import MultiScaleViT
from cmlpl_tpu_torch.models.ssftt import SSFTTnet
from cmlpl_tpu_torch.models.ssrn import SSRN


class BaseNet2Zoo(_Stem):
    """The zoo variant of BaseNet2 (conpared_models.py:391-458): a feature
    head off the spectral path, ``feat_ss`` -> ``feat_ss2`` -> l2norm
    (64-d), and the classifier on the joint concat.  Returns (logits,
    feature); f32.  ``tp`` splits ``feat_spe`` and the classifier, as
    BaseNet2's; the feature head reads the gathered ``y``."""

    def __init__(self, num_features: int = 103, dropout: float = 0.0,
                 num_classes: int = 9, n_pc: int = 60, patch_size: int = 20,
                 tp=None):
        super().__init__(num_features, n_pc, "float32", tp)
        self.dropout = dropout
        self.feat_ss = nn.Linear(1024, 256)
        self.feat_ss2 = nn.Linear(256, 64)
        self.classifier = nn.Linear(tpc.width(joint_dim(patch_size), self.tp),
                                    num_classes)
        self._split(self.classifier.weight)

    def forward(self, xp: torch.Tensor, x: torch.Tensor,
                generator: torch.Generator | None = None):
        with compute_precision("float32"):
            h, y = self.stem(xp, x)
            z = torch.cat([h, y], dim=1)
            feat = l2_normalize(self.feat_ss2(F.relu(self.feat_ss(y))))
            if self.dropout > 0 and self.training:
                z = dropout(z, self.dropout, generator)
            return self._classify(self.classifier, z), feat


@torch.no_grad()
def weight_ema(base: dict, ema: dict, alpha: float) -> None:
    """EMA-teacher update over matching tensors, in place:
    ``E = B * (1 - alpha) + E * alpha`` (reference WeightEMA_BN,
    models.py:155-164)."""
    for name, e in ema.items():
        e.copy_(base[name] * (1.0 - alpha) + e * alpha)


def spa_randomization(x: torch.Tensor, perm: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """Spatial style randomisation (models.py:166-191): each sample of the
    (B, H, W, C) ``x`` re-normalised over (H, W) and given the statistics
    of sample ``perm[b]``.  ``perm`` is the batch permutation, e.g.
    ``torch.randperm(B, generator=g)``."""
    b = x.shape[0]
    flat = x.reshape(b, -1, x.shape[-1])
    var, mean = torch.var_mean(flat, dim=1, keepdim=True, correction=0)
    normed = (flat - mean) / torch.sqrt(var + eps)
    out = normed * torch.sqrt(var[perm] + eps) + mean[perm]
    return out.reshape(x.shape)


def spe_randomization(x: torch.Tensor, perm: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """Spectral style randomisation (models.py:196-224, unlabeled branch):
    each sample's feature statistics applied to the normalised features of
    sample ``perm[b]`` (held constant for the gradient)."""
    var, mean = torch.var_mean(x, dim=1, keepdim=True, correction=0)
    normed = (x - mean) / torch.sqrt(var + eps)
    return normed[perm].detach() * torch.sqrt(var + eps) + mean


@dataclasses.dataclass(frozen=True)
class ZooEntry:
    build: Callable[..., nn.Module]
    inputs: str            # "dual" (patch + spectrum) | "patch"
    returns_feature: bool  # (logits, feature) vs logits
    default_patch: int     # typical patch size
    default_n_pc: int      # typical channel count (-1 = full bands)


def _zoo() -> dict[str, ZooEntry]:
    def basenet(cls):
        return lambda spec, n_pc, w, **kw: cls(
            num_features=spec.num_bands, num_classes=spec.num_classes,
            n_pc=n_pc, patch_size=w, **kw)

    def msvit(spec, n_pc, w, **kw):
        return MultiScaleViT(
            image_size=kw.pop("image_size", 8),
            patch_sizes=kw.pop("patch_sizes", (2, 4)),
            num_classes=spec.num_classes, dim=kw.pop("dim", 64),
            depth=kw.pop("depth", 1), heads=kw.pop("heads", 4),
            channels=n_pc, **kw)

    def banded(cls):
        return lambda spec, n_pc, w, **kw: cls(
            band=spec.num_bands, num_classes=spec.num_classes, **kw)

    return {
        "basenet1": ZooEntry(basenet(BaseNet1), "dual", True, 20, 5),
        "basenet2": ZooEntry(basenet(BaseNet2), "dual", True, 20, 60),
        "basenet2_zoo": ZooEntry(basenet(BaseNet2Zoo), "dual", True, 20, 60),
        "ssftt": ZooEntry(
            lambda spec, n_pc, w, **kw: SSFTTnet(
                num_classes=spec.num_classes, n_pc=n_pc, **kw),
            "patch", False, 13, 5),
        "dbda": ZooEntry(banded(DBDA), "patch", False, 9, -1),
        "dbda_feature": ZooEntry(banded(DBDAFeature), "patch", True, 9, -1),
        "ssrn": ZooEntry(banded(SSRN), "patch", False, 7, -1),
        "fdssc": ZooEntry(banded(FDSSC), "patch", False, 9, -1),
        "msvit": ZooEntry(msvit, "patch", False, 8, 30),
    }


ZOO = _zoo()
#: the zoo models with a ``feat_spe``: the model axis splits them
#: (``core/mesh.tp_dim``), and replicates the others
TP_MODELS = ("basenet1", "basenet2", "basenet2_zoo")


def build_model(name: str, spec, n_pc: int, patch_size: int, **kw):
    """A zoo model by name, for patches of ``patch_size`` with ``n_pc``
    channels (-1 or None: all bands); returns (module, entry)."""
    entry = ZOO[name.lower()]
    n_pc = spec.num_bands if n_pc in (-1, None) else n_pc
    return entry.build(spec, n_pc, patch_size, **kw), entry
