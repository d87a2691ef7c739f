"""Operations and bytes of the cells' work, from shapes alone, so that
every later change is measured against the same count whatever computes
the work.  A multiply-add is 2 operations; bias adds, activations, pools
and norms are not counted.

Training counts the forward from the layers' shapes and, for the
backward, each layer's weight gradient and the input gradient of every
layer whose input is not data: no gradient of a patch or a spectrum, and
nothing recomputed.  The step's objective adds its products (the
similarity matrices and their backward, the queues' smoothing).

The scene map counts the least work that classifies every pixel: the
convolutions once over the padded scene, with the pools as stride-1
pools and the second convolution dilated (the a-trous form), then each
pixel's spectral layer and classifier.  It is not one forward a pixel's
patch, which costs about 94 times as much at PaviaU's size.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

FEAT_DIM = 1024


def conv(cin: int, cout: int, taps: int, positions: int) -> int:
    """A convolution of ``taps`` kernel elements a channel pair at
    ``positions`` output positions."""
    return 2 * cin * cout * taps * positions


def dense(n_in: int, n_out: int, rows: int = 1) -> int:
    return 2 * n_in * n_out * rows


def train_flops(layers, batch: int) -> int:
    """Forward and backward of ``batch`` samples of ``layers`` [(forward
    operations a sample, input is data)]: 3 x forward, less the input
    gradient of a layer fed by data."""
    return batch * sum(f * (2 if data else 3) for f, data in layers)


def basenet2_layers(patch_size: int, n_pc: int, bands: int,
                    classes: int) -> list:
    """BaseNet2's layers a sample: 1x1 conv0 on the w x w patch, 3x3
    conv1 there, 3x3 conv2 after the first 2x2 pool, the spectral dense
    layer and the classifier on the joint feature."""
    w = patch_size
    return [(conv(n_pc, 64, 1, w * w), True),
            (conv(64, 64, 9, w * w), False),
            (conv(64, 64, 9, (w // 2) ** 2), False),
            (dense(bands, FEAT_DIM), True),
            (dense(64 * (w // 4) ** 2 + FEAT_DIM, classes), False)]


def cmlpl_step_flops(cfg: dict, warm: bool) -> int:
    """One seed's CMLPL step: both networks on the labeled + unlabeled
    batch, the two contrastive losses (U x U similarities over the
    feature, forward and the gradient of the undetached side), the
    pseudo-label graph, and with warm queues each queue's smoothing (U
    rows against the queue's features, then its probabilities)."""
    lb, ub = cfg["labeled_batch"], cfg["unlabeled_batch"]
    c = cfg["classes"]
    nets = 2 * train_flops(basenet2_layers(cfg["patch_size"], cfg["n_pc"],
                                           cfg["bands"], c), lb + ub)
    objective = 2 * 2 * dense(FEAT_DIM, ub, ub) + dense(c, ub, ub)
    if warm:
        q = 5 * lb * 2
        objective += 2 * (dense(FEAT_DIM, q, ub) + dense(q, c, ub))
    return nets + objective


def ssrn_layers(patch_size: int, bands: int, classes: int) -> list:
    """SSRN's layers a sample (layout H, W, D): the (1, 1, 7) stride-2
    spectral conv, four (1, 1, 7) residual convs, the conv over the
    remaining depth to 128, the (3, 3, 128) conv, four (3, 3, 1) residual
    convs and the head."""
    w = patch_size
    d = (bands - 7) // 2 + 1
    kd = math.ceil((bands - 6) / 2)
    s = w - 2
    return ([(conv(1, 24, 7, w * w * d), True)]
            + [(conv(24, 24, 7, w * w * d), False)] * 4
            + [(conv(24, 128, kd, w * w * (d - kd + 1)), False),
               (conv(1, 24, 9 * 128, s * s), False)]
            + [(conv(24, 24, 9, s * s), False)] * 4
            + [(dense(24 * (s // 5) ** 2, classes), False)])


def supervised_step_flops(cfg: dict) -> int:
    """One supervised SSRN step of ``cfg["batch"]`` samples."""
    return train_flops(ssrn_layers(cfg["patch_size"], cfg["bands"],
                                   cfg["classes"]), cfg["batch"])


def dense_map_flops(cfg: dict) -> int:
    """The least work of a BaseNet2 map of a rows x cols scene (the module
    docstring): over the (rows + w) x (cols + w) padded scene, conv0 and
    conv1 at every position, conv2 at every position of the stride-1
    pool, then per pixel the spectral layer and the classifier."""
    w = cfg["patch_size"]
    h, wd = cfg["rows"] + w, cfg["cols"] + w
    pixels = cfg["rows"] * cfg["cols"]
    return (conv(cfg["n_pc"], 64, 1, h * wd) + conv(64, 64, 9, h * wd)
            + conv(64, 64, 9, (h - 1) * (wd - 1))
            + dense(cfg["bands"], FEAT_DIM, pixels)
            + dense(64 * (w // 4) ** 2 + FEAT_DIM, cfg["classes"], pixels))


def _touched(ids: np.ndarray, cols: int, w: int) -> int:
    """Pixels of the padded cube that the patches of ``ids`` cover."""
    r, c = ids // cols, ids % cols
    r0 = int(r.min())
    mask = np.zeros((int(r.max()) - r0 + w, cols + w), bool)
    for row in np.unique(r):
        cs = c[r == row]
        mask[row - r0:row - r0 + w, int(cs.min()):int(cs.max()) + w] = True
    return int(mask.sum())


def gather_bytes(ids: np.ndarray, cols: int, w: int, channels: int,
                 elt: int = 4) -> int:
    """The least bytes a gather of the patches of ``ids`` moves: each
    output byte written once, each id read once and each covered pixel of
    the padded cube read once.  The ids of a row must be contiguous (a
    tile of the map is)."""
    return (len(ids) * (w * w * channels * elt + 4)
            + _touched(ids, cols, w) * channels * elt)


def map_gather_bytes(cfg: dict) -> int:
    """The bytes of kernel 1's gathers of one tiled map: the pixels in
    order, ``serve_tile`` a launch, counting only the scene's pixels."""
    pixels = cfg["rows"] * cfg["cols"]
    tile = cfg["serve_tile"]
    ids = np.arange(pixels)
    return sum(gather_bytes(ids[s:s + tile], cfg["cols"], cfg["patch_size"],
                            cfg["n_pc"]) for s in range(0, pixels, tile))


def map_tiles(cfg: dict) -> int:
    return -(-cfg["rows"] * cfg["cols"] // cfg["serve_tile"])


def peaks(kind: str) -> dict | None:
    """The published peaks of the card named ``kind`` (the longest entry
    of ``peaks.json`` that it starts with), or None."""
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
        table = json.load(f)
    names = [n for n in table if kind.startswith(n)]
    return table[max(names, key=len)] if names else None
