"""The patch-gather kernel's launch plan, a mirror of its copy arithmetic,
and its C binding, on the CPU.

The CUDA kernel (``cmlpl_tpu_torch/csrc/patch_gather.cu``) runs only on
the card, where ``chip_smoke.py`` holds it bitwise against the plain
gather.  What decides where it reads and writes is reachable here:
:func:`gather_plan` is Python, and :func:`mirror` repeats the kernel's
address arithmetic: on the groups path each patch row covers the aligned
16-byte chunks of out that hold any of its bytes, reads each as the
aligned 16 or 32 bytes around its source (or, where those would leave the
cube, the row's own elements) and writes only the row's bytes.  It runs
over a byte image of the cube that may start at any element, must give
the plain gather's bytes and may read no byte outside the cube.  Last,
the ``extern "C"`` prototypes of ``csrc/*.cu`` are held against
``_build.SIGNATURES``, which ctypes trusts.
"""

import ctypes
import math
import os
import re

import numpy as np
import pytest
import torch

from cmlpl_tpu_torch.data.patches import (clamped_starts, gather_patches,
                                          patch_pad_width)
from cmlpl_tpu_torch.ops import _build
from cmlpl_tpu_torch.ops.patch_gather import (MAX_BLOCK_THREADS,
                                              PATH_GROUPS, PATH_ROWS,
                                              ROW_THREADS, SMALL_ROWS,
                                              block_threads, gather_plan,
                                              groups_plan)
from torch_port_threads import one_torch_thread  # noqa: F401

SMS = 132   # H100 SXM
# every launch site of PERF.md's kernel table, (batch, w, C): map tiles and
# the zoo's steps at each (w, C), the training pool and the per-step batch
SITES = [(512, 20, 60), (10240, 20, 60), (128, 20, 60), (45, 20, 60),
         (512, 20, 5), (45, 20, 5), (512, 13, 5), (45, 13, 5),
         (512, 9, 103), (45, 9, 103), (512, 7, 103), (45, 7, 103),
         (512, 8, 30), (45, 8, 30)]
ELEMENTS = {4: (np.int32, torch.int32), 2: (np.int16, torch.int16)}


def _groups(batch, plan):
    if plan.path == PATH_ROWS:
        return [1] * batch
    n = -(-batch // plan.group)
    return [min(plan.group, batch - g * plan.group) for g in range(n)]


@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("batch,w,c", SITES)
def test_plan_at_every_site(batch, w, c, elt):
    """At the site, at B = 1 and at B = G + 1 (a ragged last group): the
    groups cover B exactly, a block of (32, ceil(G w / R)) threads fits,
    the grid is at least one block and at most one a group.  Neither path
    uses shared memory (a block may hold 232,448 bytes), so a plan names
    none."""
    plan0 = gather_plan(batch, w, c, elt, SMS)
    for b in (batch, 1, plan0.group + 1):
        plan = gather_plan(b, w, c, elt, SMS)
        assert plan._fields == ("path", "group", "rows_per_warp", "grid")
        assert plan.grid >= 1
        sizes = _groups(b, plan)
        assert sum(sizes) == b and min(sizes) > 0
        if plan.path == PATH_ROWS:
            # wide rows, or a small batch of rows of at most two rounds
            assert w * c * elt >= 2048 or (b * w < SMALL_ROWS and
                                           w * c * elt // 16 + 2 <= 62)
            assert (plan.group, plan.rows_per_warp, plan.grid) == (1, 1,
                                                                    b * w)
            assert block_threads(plan, w) == ROW_THREADS
        else:
            assert plan.path == PATH_GROUPS
            rows = plan.group * w
            threads = block_threads(plan, w)
            assert threads == 32 * -(-rows // plan.rows_per_warp)
            assert threads <= MAX_BLOCK_THREADS
            # 4 rows a warp only where a row fits one round of its lanes
            # (31 out chunks)
            assert plan.rows_per_warp < 4 or w * c * elt // 16 + 2 <= 31
            assert plan.grid <= len(sizes)


@pytest.mark.parametrize("elt", [4, 2])
def test_plan_paths(elt):
    """The wide rows of (20, 60) keep the row copy at every batch; the
    zoo's narrow or oddly strided rows take the groups at a map tile, 4
    rows a warp where a row fits one round of a warp's lanes, else 2; a
    small batch of narrow rows takes the row copy, of wider ones a row a
    warp."""
    for b in (1, 45, 128, 512, 10240):
        assert gather_plan(b, 20, 60, elt, SMS).path == PATH_ROWS
    for w, c in ((13, 5), (20, 5), (8, 30), (7, 103), (9, 103)):
        tile = gather_plan(512, w, c, elt, SMS)
        assert tile.path == PATH_GROUPS
        narrow = w * c * elt // 16 + 2 <= 31
        assert tile.rows_per_warp == (4 if narrow else 2)
        step = gather_plan(45, w, c, elt, SMS)
        if w * c * elt // 16 + 2 <= 62:
            assert step.path == PATH_ROWS
        else:
            assert (step.path, step.rows_per_warp) == (PATH_GROUPS, 1)
        assert gather_plan(1, w, c, elt, SMS).path == step.path
    # a window of more than 32 rows does not fit a block's warps
    assert gather_plan(512, 33, 5, elt, SMS).path == PATH_ROWS
    with pytest.raises(ValueError):
        gather_plan(0, 9, 103, elt, SMS)
    with pytest.raises(ValueError):
        groups_plan(512, 13, 3, 1, SMS)
    with pytest.raises(ValueError):
        groups_plan(512, 13, 1, 3, SMS)


# ----------------------------------------------------------------- mirror --

class Memory:
    """A byte image with the cube at byte ``lo`` (the image itself starts
    16-byte aligned); every read is held inside [lo, hi)."""

    def __init__(self, cube_bytes: np.ndarray, lo: int):
        self.lo, self.hi = lo, lo + cube_bytes.size
        self.mem = np.zeros(self.hi + 64, np.uint8)
        self.mem[lo:self.hi] = cube_bytes

    def read(self, a: int, n: int) -> np.ndarray:
        assert self.lo <= a and a + n <= self.hi, (a, n, self.lo, self.hi)
        return self.mem[a:a + n]


def _window_start(i, cols, cube_rows, cube_cols, w):
    r = i // cols          # floor division, as floor_div
    c = i - r * cols
    r += cube_rows if r < 0 else 0
    c += cube_cols if c < 0 else 0
    return (min(max(r, 0), cube_rows - w), min(max(c, 0), cube_cols - w))


def mirror(memory, shape, elt, idx, cols, w, plan):
    """The kernel's bytes of out for ``plan``, out at address 0."""
    cube_rows, cube_cols, ch = shape
    batch = len(idx)
    row_elems = w * ch
    row_bytes = row_elems * elt
    out = np.full(batch * w * row_bytes, 0xAB, np.uint8)
    written = np.zeros(out.size, np.int64)

    def src(rc, i):
        return memory.lo + ((rc[0] + i) * cube_cols + rc[1]) * ch * elt

    if plan.path == PATH_ROWS:
        for b in range(batch):
            rc = _window_start(int(idx[b]), cols, cube_rows, cube_cols, w)
            for i in range(w):
                d = (b * w + i) * row_bytes
                out[d:d + row_bytes] = memory.read(src(rc, i), row_bytes)
        return out

    groups = -(-batch // plan.group)
    # blocks stride over the groups; each warp copies one patch row
    for blk in range(plan.grid):
        for g in range(blk, groups, plan.grid):
            for b in range(g * plan.group,
                           min((g + 1) * plan.group, batch)):
                rc = _window_start(int(idx[b]), cols, cube_rows, cube_cols,
                                   w)
                for i in range(w):
                    copy_row(memory, out, written, src(rc, i),
                             (b * w + i) * row_bytes, row_bytes)
    assert (written == 1).all(), "a byte of out written twice or never"
    return out


def copy_row(memory, out, written, sj, d0, row_bytes):
    """A warp's row (its source byte for out byte d0 at sj): out chunk c,
    of the aligned 16-byte chunks of out that hold any of the row's bytes,
    is the 16 bytes at ``sub`` of the aligned source chunks c and c + 1
    from ``base``; a source chunk is loaded whole where it lies in the
    cube, else only its bytes in the cube (the rest zero); each out chunk
    writes the row's bytes alone."""
    a0 = d0 & ~15
    chunks = ((d0 + row_bytes - 1) & ~15) - a0
    chunks = chunks // 16 + 1
    assert chunks <= row_bytes // 16 + 2
    s = sj - (d0 & 15)
    sub = s & 15
    base = s - sub
    # source chunks 0..chunks, loaded
    at = base + np.arange(16 * (chunks + 1))
    inside = (memory.lo <= at) & (at < memory.hi)
    loaded = np.zeros(at.size, np.uint8)
    loaded[inside] = memory.mem[at[inside]]
    k = np.arange(16)
    outb = a0 + 16 * np.arange(chunks)[:, None] + k
    mine = (outb >= d0) & (outb < d0 + row_bytes)
    value = loaded[16 * np.arange(chunks)[:, None] + sub + k]
    # the row's bytes come from loaded cube bytes
    assert inside[(16 * np.arange(chunks)[:, None] + sub + k)[mine]].all(), \
        "a row byte from outside the cube"
    out[outb[mine]] = value[mine]
    written[outb[mine]] += 1


# (w, C): the zoo's sites and the serving one
MIRROR_SITES = [(13, 5), (20, 5), (8, 30), (7, 103), (9, 103), (20, 60)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("w,c", MIRROR_SITES)
def test_mirror_is_the_plain_gather(w, c, elt, offset):
    """At B = 1 and B = G + 1 (a ragged last group), with the first window,
    the last window (which ends at the cube's last byte), ids off the scene
    and random ids; the cube at an aligned base or one element past it;
    by the plan's launch and by the groups path (``_plans``)."""
    rng = np.random.default_rng(w * 1000 + c + elt + offset)
    rows, cols = 6, 5
    hw = patch_pad_width(w)
    shape = (rows + 2 * hw, cols + 2 * hw, c)
    npdt, tdt = ELEMENTS[elt]
    raw = rng.integers(0, 256, size=math.prod(shape) * elt, dtype=np.uint8)
    memory = Memory(raw, 64 + offset * elt)
    cube = torch.from_numpy(raw.view(npdt).reshape(shape).copy())
    # a divisor that makes the cube's last window reachable: start
    # (cube_rows - w, cube_cols - w) is id (cube_rows - w) * cols' + cols'-1
    last_cols = shape[1] - w + 1
    cases = [(np.array([(shape[0] - w) * last_cols + last_cols - 1, 0],
                       np.int32), last_cols)]
    group = gather_plan(512, w, c, elt, SMS).group
    # B = 1, B = G + 1, and enough groups that one SM's blocks stride
    for b in (1, group + 1, 9 * group + 3):
        ids = rng.integers(-rows * cols, 2 * rows * cols, size=b)
        ids[0] = rows * cols - 1
        cases.append((ids.astype(np.int32), cols))
    for ids, cl in cases:
        want = gather_patches(cube, torch.from_numpy(ids), cols=cl, w=w)
        assert want.dtype == tdt
        for plan in _plans(len(ids), w, c, elt):
            got = mirror(memory, shape, elt, ids, cl, w, plan)
            assert got.tobytes() == want.numpy().tobytes(), (ids, plan)
    # the last window's last pixel is the cube's last pixel
    r, cc = clamped_starts(torch.tensor(cases[0][0][:1]), last_cols,
                           shape[0], shape[1], w)
    assert (int(r) + w, int(cc) + w) == shape[:2]


def _plans(batch, w, c, elt):
    """The plan's launch; the groups path at 1 and 2 patches a block and
    every rows a warp that fits; and on one SM, where a block strides over
    several groups."""
    yield gather_plan(batch, w, c, elt, SMS)
    for group in (1, 2):
        for per_warp in (1, 2, 4):
            if 32 * -(-group * w // per_warp) <= MAX_BLOCK_THREADS:
                yield groups_plan(batch, w, group, per_warp, SMS)
    yield groups_plan(batch, w, 1, 1, 1)


# ---------------------------------------------------------------- binding --

_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int64_t": ctypes.c_int64, "int": ctypes.c_int}


def _prototypes():
    protos = {}
    for path in _build.sources():
        with open(path) as f:
            text = f.read()
        for ret, name, args in re.findall(
                r'extern "C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)', text):
            types = []
            for arg in args.split(","):
                decl = " ".join(arg.split())
                m = re.fullmatch(r"(const void\s*\*|void\s*\*|int64_t|int)"
                                 r"\s*\w+", decl)
                assert m, f"{os.path.basename(path)}: {name}: {decl!r}"
                types.append(_CTYPES[m.group(1).replace(" *", "*")])
            protos[name] = (tuple(types), _CTYPES[ret])
    return protos


def test_c_prototypes_match_the_ctypes_signatures():
    """Argument count, and pointer, int64_t or int at each position: a
    wrong argtype cuts a pointer or an int64 silently."""
    protos = _prototypes()
    assert set(protos) == set(_build.SIGNATURES)
    for name, (argtypes, restype) in _build.SIGNATURES.items():
        assert protos[name] == (tuple(argtypes), restype), name


def test_the_plan_fills_the_entry_points_arguments():
    """The gather wrappers pass (cube, idx, out, batch, the cube's three
    dims, cols, w), the plan's fields in order, then the stream."""
    plan = gather_plan(512, 9, 103, 4, SMS)
    for name in ("cmlpl_patch_gather_f32", "cmlpl_patch_gather_bf16"):
        argtypes, _ = _build.SIGNATURES[name]
        assert len(argtypes) == 9 + len(plan) + 1
        assert argtypes[9:9 + len(plan)] == (ctypes.c_int,) * len(plan)
