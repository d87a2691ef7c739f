"""BaseNet2, the CMLPL and CPS backbone (reference ``tools/models.py:97-152``;
JAX counterpart ``cmlpl_tpu/models/basenet.py:34-76``), the zoo's
BaseNet1 (``:79-110``), and the CCT family: ``CCTNet``, ``Decoder`` and
``LinearClassifier`` (``:113-196``).

The public input is NHWC ``(B, w, w, n_pc)`` as in the JAX package.  The
patch is viewed as NCHW with channels-last strides for cuDNN, and the
spatial flatten runs in (H, W, C) order like the flax model, so weights
carried over from JAX (:mod:`cmlpl_tpu_torch.weights`) line up with the
classifier's rows.  BaseNet2 and CCTNet share one stem (the JAX package
writes it twice) and its layer names.

Built with ``tp`` (a mesh of ``core/mesh.create_mesh_2d`` whose model
axis has more than one rank), a model holds this rank's shards of the
wide spectral path (``core/mesh.tp_dim``): ``feat_spe`` its 1,024 / tp
output features and bias, whose output is gathered whole
(``core/tp.gather_cols``) before the concat and the l2-norm; a
``classifier`` its block of input columns, the rows of JAX's
``P("model", None)`` kernel (the flatten is in JAX's order, so the
blocks line up), against this rank's columns of the concat
(``core/tp.slice_cols``), the partial logits summed over the model ranks
(``core/tp.sum_partials``) and the replicated bias added once, after
the sum.  Dropout draws the whole mask, as one process does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cmlpl_tpu_torch.core import tp as tpc
from cmlpl_tpu_torch.core.mesh import Mesh, is_tp
from cmlpl_tpu_torch.device import compute_precision
from cmlpl_tpu_torch.models.common import (avg_pool2, dropout,  # noqa: F401
                                           keep_mask, l2_normalize)

FEAT_DIM = 1024       # spectral feature width (models.py:119)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def joint_dim(patch_size: int) -> int:
    """Width of the joint feature: the (w/4)^2 x 64 spatial flatten and the
    spectral feature (2624 at w = 20, models.py:127)."""
    return 64 * (patch_size // 4) ** 2 + FEAT_DIM


class _Stem(nn.Module):
    """The spectral-spatial stem: conv0-conv2 with two residual average
    pools on the patch, ``feat_spe`` on the spectrum.

    ``compute_dtype``: dtype the stem computes in; params stay f32 and are
    cast per call, as flax's ``dtype`` does, so autograd carries the bf16
    products' gradients back to the f32 params.  The model's own calls set
    the TF32 switches from it (``compute_precision``) and restore them.
    ``tp``: the mesh whose model axis splits the spectral path (the
    module docstring), or None."""

    def __init__(self, num_features: int, n_pc: int, compute_dtype: str,
                 tp: Mesh | None = None):
        super().__init__()
        if compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        self.precision = compute_dtype
        self.compute_dtype = _DTYPES[compute_dtype]
        self.tp = tp if is_tp(tp) else None
        self.conv0 = nn.Conv2d(n_pc, 64, 1)
        self.conv1 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv2 = nn.Conv2d(64, 64, 3, padding=1)
        self.feat_spe = nn.Linear(num_features, tpc.width(FEAT_DIM, self.tp))
        self._split(self.feat_spe.weight, self.feat_spe.bias)

    def _split(self, *params) -> None:
        """Marks ``params`` as this rank's shards (``tp_split``: their
        gradients are not the model ranks' one gradient,
        ``core/mesh.all_reduce_grads``)."""
        if self.tp is not None:
            for p in params:
                p.tp_split = True

    def _conv(self, layer: nn.Conv2d, h: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(h, layer.weight.to(dt), layer.bias.to(dt),
                        padding=layer.padding)

    def _dense(self, layer: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(h, layer.weight.to(dt), layer.bias.to(dt))

    def _classify(self, layer: nn.Linear, z: torch.Tensor) -> torch.Tensor:
        """``layer`` (a classifier, whose input columns the model axis
        splits) on the replicated ``z``."""
        if self.tp is None:
            return self._dense(layer, z)
        dt = self.compute_dtype
        part = F.linear(tpc.slice_cols(z, self.tp), layer.weight.to(dt))
        return tpc.sum_partials(part, self.tp) + layer.bias.to(dt)

    def stem(self, xp: torch.Tensor, x: torch.Tensor):
        """(spatial flatten (B, 64 (w/4)^2) in (H, W, C) order, ReLU'd
        spectral feature (B, 1024)), both in the compute dtype."""
        h = xp.to(self.compute_dtype).permute(0, 3, 1, 2)  # NCHW view
        h = self._conv(self.conv0, h)
        res = h
        h = F.relu(self._conv(self.conv1, h) + res)
        h = avg_pool2(h)
        res = h
        h = F.relu(self._conv(self.conv2, h) + res)
        h = avg_pool2(h)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        y = F.relu(self._dense(self.feat_spe, x.to(self.compute_dtype)))
        return h, tpc.gather_cols(y, self.tp)


class BaseNet2(_Stem):
    """Dual-branch spectral-spatial CNN.

    Inputs: ``xp`` (B, w, w, n_pc) PCA patch (NHWC), ``x`` (B, bands)
    spectrum.  Returns (logits, l2-normalised spectral feature), both f32.
    """

    def __init__(self, num_features: int = 103, dropout: float = 0.0,
                 num_classes: int = 9, n_pc: int = 60, patch_size: int = 20,
                 compute_dtype: str = "float32", tp: Mesh | None = None):
        super().__init__(num_features, n_pc, compute_dtype, tp)
        self.dropout = dropout
        self.classifier = nn.Linear(tpc.width(joint_dim(patch_size), self.tp),
                                    num_classes)
        self._split(self.classifier.weight)

    def forward(self, xp: torch.Tensor, x: torch.Tensor,
                generator: torch.Generator | None = None,
                keep: torch.Tensor | None = None):
        """In training mode the dropout mask is ``keep`` or, when None,
        drawn from ``generator`` (torch's default generator when None)."""
        with compute_precision(self.precision):
            h, y = self.stem(xp, x)
            z = torch.cat([h, y], dim=1)
            feat = l2_normalize(y.float())
            if self.dropout > 0 and self.training:
                z = dropout(z, self.dropout, generator, keep)
            logits = self._classify(self.classifier, z)
        return logits.float(), feat


class BaseNet1(_Stem):
    """Simpler dual-branch net (conpared_models.py:192-247): BaseNet2's
    stem, then a 256-d joint feature ``feat_ss`` over the concat, ReLU,
    dropout and the classifier.  Returns (logits, the 256-d feature before
    its ReLU); f32."""

    def __init__(self, num_features: int = 103, dropout: float = 0.0,
                 num_classes: int = 9, n_pc: int = 5, patch_size: int = 20,
                 tp: Mesh | None = None):
        super().__init__(num_features, n_pc, "float32", tp)
        self.dropout = dropout
        self.feat_ss = nn.Linear(joint_dim(patch_size), 256)
        self.classifier = nn.Linear(tpc.width(256, self.tp), num_classes)
        self._split(self.classifier.weight)

    def forward(self, xp: torch.Tensor, x: torch.Tensor,
                generator: torch.Generator | None = None):
        with compute_precision("float32"):
            h, y = self.stem(xp, x)
            feat = self.feat_ss(torch.cat([h, y], dim=1))
            z = F.relu(feat)
            if self.dropout > 0 and self.training:
                z = dropout(z, self.dropout, generator)
            return self._classify(self.classifier, z), feat


class CCTNet(_Stem):
    """CCT encoder (models.py:229-287): BaseNet2's stem returning the f32
    joint feature twice.  ``with_decoder`` adds ``feat_ss`` and the
    reconstruction ``Decoder`` (f32, as in flax) and returns its output
    third.

    ``dropout`` and ``num_classes`` are taken for the JAX signature and
    unused: the JAX CCTNet applies no dropout, although its trainer passes
    a dropout key (``cmlpl_tpu/models/basenet.py:163-185``).  ``tp``
    splits ``feat_spe`` alone: it has no classifier."""

    def __init__(self, num_features: int = 103, dropout: float = 0.0,
                 num_classes: int = 9, n_pc: int = 60, patch_size: int = 20,
                 with_decoder: bool = False,
                 compute_dtype: str = "float32", tp: Mesh | None = None):
        super().__init__(num_features, n_pc, compute_dtype, tp)
        self.with_decoder = with_decoder
        if with_decoder:
            self.feat_ss = nn.Linear(joint_dim(patch_size), 256)
            # the JAX CCTNet builds its Decoder at the default patch size
            self.decoder = Decoder(num_features, n_pc)

    def forward(self, xp: torch.Tensor, x: torch.Tensor):
        with compute_precision(self.precision):
            h, y = self.stem(xp, x)
        fea1 = torch.cat([h, y], dim=1).float()
        if self.with_decoder:
            return fea1, fea1, self.decoder(self.feat_ss(fea1))
        return fea1, fea1


def _upsample_nearest(x: torch.Tensor, size: int) -> torch.Tensor:
    """``nn.Upsample(size)`` nearest-neighbour of NHWC ``x`` to (size,
    size), with the JAX package's index arithmetic
    (``cmlpl_tpu/models/basenet.py:137-142``)."""
    _, h, w, _ = x.shape
    rows = torch.arange(size, device=x.device) * h // size
    cols = torch.arange(size, device=x.device) * w // size
    return x[:, rows][:, :, cols]


class Decoder(nn.Module):
    """Reconstructs the spectrum and the PCA patch from a 256-d code
    (models.py:289-320).  Returns (spectrum (B, bands), patch (B, w, w,
    n_pc) NHWC), f32."""

    def __init__(self, num_features: int = 103, n_pc: int = 60,
                 patch_size: int = 20):
        super().__init__()
        self.patch_size = patch_size
        self.p = patch_size // 4
        self.recon_y1 = nn.Linear(256, 128)
        self.recon_y2 = nn.Linear(128, num_features)
        self.recon_x = nn.Linear(256, 64 * self.p * self.p)
        self.re_conv1 = nn.Conv2d(64, 64, 3, padding=1)
        self.re_conv2 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv0 = nn.Conv2d(64, n_pc, 1)

    def forward(self, code: torch.Tensor):
        y_re = self.recon_y2(self.recon_y1(code))
        h = self.recon_x(code).reshape(code.shape[0], self.p, self.p, 64)
        h = _upsample_nearest(h, 4)
        h = self.re_conv1(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        h = _upsample_nearest(h, self.patch_size).permute(0, 3, 1, 2)
        x_re = self.conv0(self.re_conv2(h)).permute(0, 2, 3, 1)
        return y_re, x_re


class LinearClassifier(nn.Module):
    """Linear head over the joint feature (models.py:322-330)."""

    def __init__(self, num_classes: int, in_features: int = joint_dim(20)):
        super().__init__()
        self.fc = nn.Linear(in_features, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)
