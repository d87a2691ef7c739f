"""The operation and byte counts against hand counts at the cells'
shapes."""

import numpy as np

from portbench import counts

CMLPL = dict(labeled_batch=128, unlabeled_batch=128, classes=9,
             patch_size=20, n_pc=60, bands=103, rows=610, cols=340,
             serve_tile=512)


def test_basenet2_forward():
    # conv0 2*60*64*400, conv1 2*9*64*64*400, conv2 2*9*64*64*100,
    # feat_spe 2*103*1024, classifier 2*2624*9
    layers = counts.basenet2_layers(20, 60, 103, 9)
    assert [f for f, _ in layers] == [3072000, 29491200, 7372800, 210944,
                                      47232]
    assert sum(f for f, _ in layers) == 40194176


def test_cmlpl_step():
    net = 3 * 40194176 - 3072000 - 210944          # no data gradients
    contrast = 4 * 2 * 128 * 128 * 1024
    graph = 2 * 128 * 128 * 9
    smooth = 2 * (2 * 128 * 1280 * 1024 + 2 * 128 * 1280 * 9)
    assert counts.cmlpl_step_flops(CMLPL, warm=False) == \
        2 * 256 * net + contrast + graph
    assert counts.cmlpl_step_flops(CMLPL, warm=True) == \
        2 * 256 * net + contrast + graph + smooth


def test_ssrn():
    # (B, C, H, W, D): depth 49 after the stride-2 stem, kernel 49 to
    # depth 1, then 5x5 after the (3, 3, 128) conv
    fwd = (2 * 7 * 24 * 49 * 49 + 4 * 2 * 7 * 24 * 24 * 49 * 49
           + 2 * 49 * 24 * 128 * 49 + 2 * 9 * 128 * 24 * 25
           + 4 * 2 * 9 * 24 * 24 * 25 + 2 * 24 * 9)
    assert sum(f for f, _ in counts.ssrn_layers(7, 103, 9)) == fwd
    first = 2 * 7 * 24 * 49 * 49
    assert counts.supervised_step_flops(
        dict(patch_size=7, bands=103, classes=9, batch=45)) == \
        45 * (3 * fwd - first)


def test_dense_map():
    h, w, px = 630, 360, 610 * 340
    want = (2 * 60 * 64 * h * w + 2 * 9 * 64 * 64 * h * w
            + 2 * 9 * 64 * 64 * (h - 1) * (w - 1)
            + px * (2 * 103 * 1024 + 2 * 2624 * 9))
    assert counts.dense_map_flops(CMLPL) == want == 88657630208


def test_gather_bytes_of_a_tile():
    # pixels 0..511: scene row 0 whole and 172 of row 1; their 20x20
    # windows cover columns 0..358 of padded rows 0..19 (the padded cube's
    # last column is in no window) and columns 0..190 of padded row 20
    touched = 20 * 359 + 191
    want = 512 * 20 * 20 * 60 * 4 + 512 * 4 + touched * 60 * 4
    assert counts.gather_bytes(np.arange(512), 340, 20, 60) == want
    # the 512-tile bound over 3.35 TB/s: 15.20 us (the kernel table's)
    assert abs(want / 3.35e12 * 1e6 - 15.20) < 0.01


def test_map_gathers():
    assert counts.map_tiles(CMLPL) == 406
    total = counts.map_gather_bytes(CMLPL)
    assert total > 610 * 340 * 20 * 20 * 60 * 4
    assert total < 406 * counts.gather_bytes(np.arange(512), 340, 20, 60) \
        + 406 * 2 * 360 * 60 * 4


def test_peaks():
    p = counts.peaks("NVIDIA H100 80GB HBM3")
    assert p["flops_per_s"]["float32"] == 67e12
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert counts.peaks("Some Other Card") is None
