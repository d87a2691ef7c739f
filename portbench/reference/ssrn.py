"""SSRN, the spectral-spatial residual network (Zhong et al., IEEE TGRS
2018; the CMLPL reference's comparison model,
``tools/conpared_models.py:1086-1163``), and its supervised steps.

Layout (B, C, H, W, D), D the spectral axis.  A (1, 1, 7) convolution of
stride 2 on the spectra to 24 channels, BatchNorm, ReLU; two spectral
residual blocks of (1, 1, 7) convolutions; a convolution over the whole
remaining depth to 128 channels, whose channels become the depth of the
spatial stage; a (3, 3, 128) convolution to 24 channels; two spatial
residual blocks of (3, 3, 1) convolutions; a (5, 5, 1) average pool and
a linear head.  A residual block is conv, ReLU, BatchNorm, ReLU, conv,
BatchNorm, then ReLU of the sum with its input.  BatchNorm in training
normalises by the batch's mean and biased variance (eps 1e-5 in the
blocks, 1e-3 after the stem convolutions, as flax's defaults and the
reference's settings give).

A step is the cross-entropy of the batch and one Adam step, with no
random draw (SSRN has no dropout).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.adam import Adam
from portbench.reference.precision import matmul_precision
from portbench.reference.prep import patches

_BLOCKS = (("res1", (1, 1, 7)), ("res2", (1, 1, 7)),
           ("res3", (3, 3, 1)), ("res4", (3, 3, 1)))


def shapes(bands: int, classes: int) -> dict:
    """name -> shape of every parameter and BatchNorm statistic."""
    s = {}

    def conv(name, cin, cout, k):
        s[f"{name}.weight"] = (cout, cin) + tuple(k)
        s[f"{name}.bias"] = (cout,)

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            s[f"{name}.{leaf}"] = (c,)

    conv("conv1", 1, 24, (1, 1, 7))
    bn("bn1", 24)
    for name, k in _BLOCKS[:2]:
        for i in (1, 2):
            conv(f"{name}.conv{i}", 24, 24, k)
            bn(f"{name}.bn{i}", 24)
    conv("conv2", 24, 128, (1, 1, math.ceil((bands - 6) / 2)))
    bn("bn2", 128)
    conv("conv3", 1, 24, (3, 3, 128))
    bn("bn3", 24)
    for name, k in _BLOCKS[2:]:
        for i in (1, 2):
            conv(f"{name}.conv{i}", 24, 24, k)
            bn(f"{name}.bn{i}", 24)
    s["head.weight"] = (classes, 24)
    s["head.bias"] = (classes,)
    return s


def _bn(p, name, x, eps):
    return F.batch_norm(x, None, None, p[f"{name}.weight"],
                        p[f"{name}.bias"], True, 0.0, eps)


def _conv(p, name, x, **kw):
    return F.conv3d(x, p[f"{name}.weight"], p[f"{name}.bias"], **kw)


def _block(p, name, x, pad):
    y = F.relu(_bn(p, f"{name}.bn1", F.relu(_conv(p, f"{name}.conv1", x,
                                                  padding=pad)), 1e-5))
    return F.relu(_bn(p, f"{name}.bn2", _conv(p, f"{name}.conv2", y,
                                              padding=pad), 1e-5) + x)


def forward(p: dict, xp: torch.Tensor) -> torch.Tensor:
    """Training-mode logits of (B, w, w, bands) patches."""
    x = F.relu(_bn(p, "bn1", _conv(p, "conv1", xp[:, None],
                                   stride=(1, 1, 2)), 1e-3))
    x = _block(p, "res2", _block(p, "res1", x, (0, 0, 3)), (0, 0, 3))
    x = F.relu(_bn(p, "bn2", _conv(p, "conv2", x), 1e-3))
    x = x.permute(0, 4, 2, 3, 1)
    x = F.relu(_bn(p, "bn3", _conv(p, "conv3", x), 1e-3))
    x = _block(p, "res4", _block(p, "res3", x, (1, 1, 0)), (1, 1, 0))
    x = F.avg_pool3d(x, (5, 5, 1), stride=(5, 5, 1))
    return F.linear(x.permute(0, 2, 3, 4, 1).flatten(1), p["head.weight"],
                    p["head.bias"])


def run(cfg: dict, params: dict, padded: torch.Tensor, cols: int, steps,
        tf32: bool = False) -> dict:
    """The supervised steps from ``params`` (statistics are not read in
    training).  ``steps``: a list of (ids, classes).  Returns ``losses``
    [loss] a step, ``grads`` of the first step and ``params`` after."""
    dev = padded.device
    params = {k: v.clone() for k, v in params.items()
              if not k.endswith(("running_mean", "running_var"))}
    opt = Adam(params, cfg["lr"])
    out = {"losses": [], "grads": None}
    with matmul_precision(tf32):
        for ids, y in steps:
            ids = torch.as_tensor(ids, device=dev).long()
            y = torch.as_tensor(y, device=dev).long()
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss = F.cross_entropy(forward(p, patches(padded, ids, cols,
                                                       cfg["patch_size"])), y)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            out["losses"].append(float(loss.detach()))
            if out["grads"] is None:
                out["grads"] = grads
            params = opt.step(params, grads)
    out["params"] = params
    return out
