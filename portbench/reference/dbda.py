"""DBDA, the Double-Branch Dual-Attention network (Li, Zheng, Duan, Yang,
Wang, Remote Sensing 12(3):582, 2020), in evaluation mode: the CMLPL
reference's comparison model, ``tools/conpared_models.py:903-1077`` (the
definition that shadows the one at ``:719``).

Layout (B, C, H, W, D), D the spectral axis, the patch (B, w, w, bands)
taken as one input channel.

- Spectral branch: a (1, 1, 7) convolution of stride 2 to 24 channels,
  then a densely connected chain of three (1, 1, 7) convolutions of 24
  channels, each fed the concatenation of all before it through
  BatchNorm and ReLU (24, 48, 72 channels in), then BatchNorm and ReLU of
  the 96-channel concatenation and a (1, 1, floor((bands - 6) / 2))
  convolution to 60 channels; channel attention (CAM) multiplies it.
- Spatial branch: a (1, 1, bands) convolution to 24 channels (depth 1),
  a dense chain of three (3, 3, 1) convolutions of 12 channels (24, 36,
  48 in), the 60-channel concatenation; position attention (PAM)
  multiplies it.
- CAM: the (60, 60) gram matrix of each sample's channels over all its
  positions (H, W and D), subtracted from its row's maximum, softmax,
  applied to the channels; PAM: 1x1 convolutions to queries and keys of
  60 // 8 = 7 channels and values of 60, softmax over the (81, 81)
  affinity of the positions.  Each returns ``gamma * attended + input``.
- Each branch's global mean, concatenated to 120, and a linear head.

Departures, all the reference code's own: ReLU where the paper uses Mish,
no dropout before the head (evaluation), BatchNorm's epsilon 1e-3 (the
JAX package's setting of the reference's layers).  In evaluation
BatchNorm normalises by its running statistics.

Parameters are a dict of the names ``shapes`` lists: the program's
``state_dict`` names (``trunk.conv11.weight``, ...), so one dict serves
both; nothing of the program is imported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.prep import patches

EPS = 1e-3
#: (conv, channels in, channels out) of the two dense chains
_SPECTRAL = (("conv12", 24, 24), ("conv13", 48, 24), ("conv14", 72, 24))
_SPATIAL = (("conv22", 24, 12), ("conv23", 36, 12), ("conv24", 48, 12))
_BNS = (("bn11", 24), ("bn12", 48), ("bn13", 72), ("bn14", 96),
        ("bn21", 24), ("bn22", 36), ("bn23", 48))
ATTENTION = 60


def spectral_kernel(bands: int) -> int:
    """Depth of the convolution that ends the spectral chain."""
    return math.floor((bands - 6) / 2)


def shapes(bands: int, classes: int) -> dict:
    """name -> shape of every parameter and BatchNorm statistic."""
    s = {}
    t = "trunk."

    def conv(name, cin, cout, k):
        s[f"{t}{name}.weight"] = (cout, cin) + tuple(k)
        s[f"{t}{name}.bias"] = (cout,)

    conv("conv11", 1, 24, (1, 1, 7))
    for name, cin, cout in _SPECTRAL:
        conv(name, cin, cout, (1, 1, 7))
    conv("conv15", 96, ATTENTION, (1, 1, spectral_kernel(bands)))
    for name, c in _BNS:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            s[f"{t}{name}.{leaf}"] = (c,)
    s[f"{t}attention_spectral.gamma"] = (1,)
    conv("conv21", 1, 24, (1, 1, bands))
    for name, cin, cout in _SPATIAL:
        conv(name, cin, cout, (3, 3, 1))
    pam = f"{t}attention_spatial."
    inner = ATTENTION // 8
    for name, cout in (("query_conv", inner), ("key_conv", inner),
                       ("value_conv", ATTENTION)):
        s[f"{pam}{name}.weight"] = (cout, ATTENTION, 1, 1)
        s[f"{pam}{name}.bias"] = (cout,)
    s[f"{pam}gamma"] = (1,)
    s["full_connection.weight"] = (classes, 2 * ATTENTION)
    s["full_connection.bias"] = (classes,)
    return s


def _conv(p, name, x, **kw):
    return F.conv3d(x, p[f"trunk.{name}.weight"], p[f"trunk.{name}.bias"],
                    **kw)


def _bn_relu(p, name, x):
    q = f"trunk.{name}."
    return F.relu(F.batch_norm(x, p[q + "running_mean"], p[q + "running_var"],
                               p[q + "weight"], p[q + "bias"], False, 0.0,
                               EPS))


def cam(gamma, x):
    """Channel attention of (B, C, ...) ``x``."""
    b, c = x.shape[:2]
    f = x.reshape(b, c, -1)
    energy = torch.bmm(f, f.transpose(1, 2))
    energy = energy.max(dim=2, keepdim=True).values - energy
    out = torch.bmm(F.softmax(energy, dim=2), f).reshape(x.shape)
    return gamma * out + x


def pam(p, x):
    """Position attention of (B, C, H, W) ``x``."""
    q = "trunk.attention_spatial."
    b, c, h, w = x.shape

    def conv(name):
        return F.conv2d(x, p[f"{q}{name}.weight"], p[f"{q}{name}.bias"])

    query = conv("query_conv").reshape(b, -1, h * w).transpose(1, 2)
    key = conv("key_conv").reshape(b, -1, h * w)
    value = conv("value_conv").reshape(b, c, h * w)
    attn = F.softmax(torch.bmm(query, key), dim=2)          # (B, HW, HW)
    out = torch.bmm(value, attn.transpose(1, 2)).reshape(b, c, h, w)
    return p[f"{q}gamma"] * out + x


def forward(p: dict, xp: torch.Tensor) -> torch.Tensor:
    """Evaluation-mode logits of (B, w, w, bands) patches."""
    x = xp[:, None]                                         # (B, 1, H, W, D)
    spec = dict(padding=(0, 0, 3))
    x11 = _conv(p, "conv11", x, stride=(1, 1, 2))
    x12 = _conv(p, "conv12", _bn_relu(p, "bn11", x11), **spec)
    x13 = _conv(p, "conv13", _bn_relu(p, "bn12", torch.cat([x11, x12], 1)),
                **spec)
    x14 = _conv(p, "conv14",
                _bn_relu(p, "bn13", torch.cat([x11, x12, x13], 1)), **spec)
    x16 = _conv(p, "conv15",
                _bn_relu(p, "bn14", torch.cat([x11, x12, x13, x14], 1)))
    x1 = cam(p["trunk.attention_spectral.gamma"], x16) * x16

    spat = dict(padding=(1, 1, 0))
    x21 = _conv(p, "conv21", x)
    x22 = _conv(p, "conv22", _bn_relu(p, "bn21", x21), **spat)
    x23 = _conv(p, "conv23", _bn_relu(p, "bn22", torch.cat([x21, x22], 1)),
                **spat)
    x24 = _conv(p, "conv24",
                _bn_relu(p, "bn23", torch.cat([x21, x22, x23], 1)), **spat)
    x25 = torch.cat([x21, x22, x23, x24], 1).squeeze(4)     # (B, 60, H, W)
    x2 = pam(p, x25) * x25

    pooled = torch.cat([x1.mean(dim=(2, 3, 4)), x2.mean(dim=(2, 3))], 1)
    return F.linear(pooled, p["full_connection.weight"],
                    p["full_connection.bias"])


def scene_logits(p: dict, padded: torch.Tensor, rows: int, cols: int,
                 w: int, block: int) -> torch.Tensor:
    """(rows * cols, classes) logits of every pixel of the prepared scene
    ``padded`` (``prep.prepare``), each from its own patch, ``block``
    patches a forward."""
    pixels = rows * cols
    out = []
    with torch.no_grad():
        for s in range(0, pixels, block):
            ids = torch.arange(s, min(s + block, pixels),
                               device=padded.device)
            out.append(forward(p, patches(padded, ids, cols, w)))
    return torch.cat(out)
