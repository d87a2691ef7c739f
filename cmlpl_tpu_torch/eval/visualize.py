"""Classification-map rendering (reference ``DrawResult``,
tools/hyper_tools.py:58-205).

Palettes live in the dataset registry; this module maps 1-based labels to
RGB and writes the map as a PNG, or as an SVG that holds that PNG (the
form ``matplotlib.pyplot.imsave`` gives an ``.svg``), with the standard
library alone: the port does not need matplotlib.
"""

from __future__ import annotations

import base64
import struct
import zlib

import numpy as np

from cmlpl_tpu_torch.registry import get_dataset


def draw_result(labels_1based: np.ndarray, data_id, rows=None,
                cols=None) -> np.ndarray:
    """Map flat 1-based labels to an (rows, cols, 3) float RGB image.

    Label 0 (background / unpredicted) renders black, matching the zeros
    the reference leaves for unmatched labels.
    """
    spec = get_dataset(data_id)
    rows = rows or spec.rows
    cols = cols or spec.cols
    labels = np.asarray(labels_1based).reshape(-1).astype(np.int64)
    palette = np.concatenate(
        [np.zeros((1, 3)), spec.palette[: int(labels.max())]], axis=0)
    img = palette[np.clip(labels, 0, palette.shape[0] - 1)]
    return img.reshape(rows, cols, 3)


def _png_bytes(img: np.ndarray) -> bytes:
    """(rows, cols, 3) float RGB in [0, 1] -> an 8-bit RGB PNG file."""
    rgb = np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    rows, cols, _ = rgb.shape
    raw = np.concatenate([np.zeros((rows, 1), np.uint8),
                          rgb.reshape(rows, cols * 3)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    header = struct.pack(">IIBBBBB", cols, rows, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def save_class_map(path: str, labels_1based: np.ndarray, data_id,
                   rows=None, cols=None) -> np.ndarray:
    """Render and save the class map (reference train.py:308-314) as
    ``.png``, or as ``.svg`` holding the PNG."""
    img = draw_result(labels_1based, data_id, rows, cols)
    png = _png_bytes(img)
    if path.endswith(".png"):
        data = png
    elif path.endswith(".svg"):
        h, w = img.shape[:2]
        data = (
            f'<svg xmlns="http://www.w3.org/2000/svg" '
            f'xmlns:xlink="http://www.w3.org/1999/xlink" width="{w}" '
            f'height="{h}" viewBox="0 0 {w} {h}"><image width="{w}" '
            f'height="{h}" xlink:href="data:image/png;base64,'
            f'{base64.b64encode(png).decode()}"/></svg>\n').encode()
    else:
        raise ValueError(f"class map must be .svg or .png, got {path!r}")
    with open(path, "wb") as f:
        f.write(data)
    return img
