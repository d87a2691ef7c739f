"""Operations of a DBDA scene map (``reference/dbda.py``), from shapes
alone, counted as ``counts.py`` counts: a multiply-add is 2 operations;
biases, BatchNorm, ReLU, softmax, the attentions' gates and the pools are
not counted.

The map counts the least work that classifies every pixel.  The spectral
branch up to its channel attention (the (1, 1, k) convolutions and the
BatchNorms between them) and the spatial branch's first convolution, a
(1, 1, bands) one, read one pixel's spectrum alone, so they are the same
in every patch that covers the pixel: they count once for each pixel of
the padded scene that some patch covers (:func:`pixel_flops`).  The
spatial dense chain, both attentions and the head count once a patch
(:func:`patch_flops`).  At PaviaU's size that is about 1.96 TFLOP a map,
where one forward a pixel's patch takes about 60.
"""

from __future__ import annotations

from portbench.counts import conv, dense

#: channels of the two branches' attended maps
ATTENTION = 60


def spectral_depths(bands: int) -> tuple[int, int, int]:
    """(depth after the stride-2 (1, 1, 7) convolution, the last spectral
    convolution's kernel depth, the depth it leaves)."""
    d = (bands - 7) // 2 + 1
    k = (bands - 6) // 2
    return d, k, d - k + 1


def pixel_flops(bands: int) -> int:
    """One pixel's spectral branch to its 60 channels, and the spatial
    branch's (1, 1, bands) convolution to 24."""
    d, k, d2 = spectral_depths(bands)
    return (conv(1, 24, 7, d) + conv(24, 24, 7, d) + conv(48, 24, 7, d)
            + conv(72, 24, 7, d) + conv(96, ATTENTION, k, d2)
            + conv(1, 24, bands, 1))


def patch_flops(patch_size: int, bands: int, classes: int) -> int:
    """One patch's spatial (3, 3, 1) dense chain, its channel attention
    (the gram matrix and its product over the w * w * depth positions),
    its position attention (queries, keys and values by 1x1
    convolutions, the affinity and its product) and the head."""
    n = patch_size * patch_size
    positions = n * spectral_depths(bands)[2]
    inner = ATTENTION // 8
    spatial = conv(24, 12, 9, n) + conv(36, 12, 9, n) + conv(48, 12, 9, n)
    cam = 2 * dense(positions, ATTENTION, ATTENTION)
    pam = (2 * conv(ATTENTION, inner, 1, n) + conv(ATTENTION, ATTENTION, 1, n)
           + dense(inner, n, n) + dense(n, ATTENTION, n))
    return spatial + cam + pam + dense(2 * ATTENTION, classes)


def covered_pixels(rows: int, cols: int, patch_size: int) -> int:
    """Pixels of the padded scene that the scene's patches cover: pixel
    (r, c)'s patch is ``padded[r:r + w, c:c + w]``."""
    return (rows + patch_size - 1) * (cols + patch_size - 1)


def map_flops(cfg: dict) -> int:
    """The least work of a DBDA map of a rows x cols scene (the module
    docstring)."""
    w = cfg["patch_size"]
    return (covered_pixels(cfg["rows"], cfg["cols"], w)
            * pixel_flops(cfg["bands"])
            + cfg["rows"] * cfg["cols"]
            * patch_flops(w, cfg["bands"], cfg["classes"]))
