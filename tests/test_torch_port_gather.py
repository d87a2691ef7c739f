"""The port's patch gathers vs the JAX package's, bitwise.

On the CPU the kernel wrappers run the plain PyTorch gather, so these
tests hold that plain version against ``cmlpl_tpu.data.patches`` and the
two Pallas TPU kernels run in interpret mode.  The CUDA kernels are held
against the same plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmlpl_tpu.data.patches import gather_patches as jax_gather_patches
from cmlpl_tpu.data.patches import pad_symmetric as jax_pad_symmetric
from cmlpl_tpu.ops.patch_gather import (build_shifted_cube_bf16,
                                        gather_patches_pallas,
                                        gather_patches_pallas_shifted)
from cmlpl_tpu_torch.data.patches import (gather_patches, gather_spectra,
                                          pad_symmetric, patch_pad_width)
from cmlpl_tpu_torch.device import resolve_device
from cmlpl_tpu_torch.ops.patch_gather import (gather_patches_bf16,
                                              gather_patches_f32)
from torch_port_threads import one_torch_thread  # noqa: F401

# (rows, cols, C, w, B, extra pad): the shapes of tests/test_pallas.py —
# w 20 and 8 over a 30x22x8 scene, odd w 9 with the extra row/col, and a
# ragged batch of 21 — plus w 20 at the slice's tile of 128; then the
# comparison zoo's (w, C) pairs at its labeled batch of 45: (13, 5)
# SSFTT, (7, 103) SSRN, (9, 103) DBDA and FDSSC (odd spans of w*C floats),
# (8, 30) MSViT, (20, 5) BaseNet1.
CASES = [(30, 22, 8, 20, 64, 0), (30, 22, 8, 8, 64, 0),
         (16, 16, 4, 9, 21, 1), (16, 16, 4, 8, 21, 0),
         (64, 48, 16, 20, 128, 0),
         (30, 22, 5, 13, 45, 0), (20, 18, 103, 7, 45, 0),
         (20, 18, 103, 9, 45, 1), (24, 20, 30, 8, 45, 0),
         (24, 20, 5, 20, 45, 0)]


def _scene(rng, rows, cols, ch, w, extra):
    X = rng.normal(size=(rows, cols, ch)).astype(np.float32)
    padded = pad_symmetric(X, patch_pad_width(w))
    np.testing.assert_array_equal(padded,
                                  jax_pad_symmetric(X, patch_pad_width(w)))
    return np.pad(padded, ((0, extra), (0, extra), (0, 0)))


@pytest.mark.parametrize("rows,cols,ch,w,b,extra", CASES)
def test_f32_gather_bitwise(rng, rows, cols, ch, w, b, extra):
    padded = _scene(rng, rows, cols, ch, w, extra)
    idx = rng.integers(0, rows * cols, size=b).astype(np.int32)
    got = gather_patches_f32(torch.from_numpy(padded),
                             torch.from_numpy(idx), cols=cols, w=w).numpy()
    want = np.asarray(jax_gather_patches(jnp.asarray(padded),
                                         jnp.asarray(idx), cols=cols, w=w))
    pallas = np.asarray(gather_patches_pallas(
        jnp.asarray(padded), jnp.asarray(idx), cols=cols, w=w,
        interpret=True))
    assert got.shape == (b, w, w, ch) and got.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == pallas.tobytes()


@pytest.mark.parametrize("rows,cols,ch,w,b,extra", CASES)
def test_bf16_gather_bitwise(rng, rows, cols, ch, w, b, extra):
    padded = _scene(rng, rows, cols, ch, w, extra)
    idx = rng.integers(0, rows * cols, size=b).astype(np.int32)
    cube = torch.from_numpy(padded).to(torch.bfloat16)
    got = gather_patches_bf16(cube, torch.from_numpy(idx), cols=cols, w=w)
    assert got.dtype == torch.bfloat16 and got.shape == (b, w, w, ch)
    want = np.asarray(gather_patches_pallas_shifted(
        build_shifted_cube_bf16(jnp.asarray(padded)), jnp.asarray(idx),
        cols=cols, w=w, interpret=True)[..., :ch])
    assert want.dtype == jnp.bfloat16
    assert got.view(torch.int16).numpy().tobytes() == \
        want.view(np.int16).tobytes()


@pytest.mark.parametrize("w,extra", [(20, 0), (9, 0), (9, 1), (8, 0)])
def test_edge_ids_clamp_like_dynamic_slice(rng, w, extra):
    """Ids off the scene (negative, past the last pixel) and windows that
    would run past the cube are clamped exactly as ``lax.dynamic_slice``
    clamps them."""
    rows, cols = 12, 10
    padded = _scene(rng, rows, cols, 3, w, extra)
    idx = np.array([0, cols - 1, rows * cols - 1, rows * cols,
                    rows * cols + 7, -1, -cols - 3, 10 ** 6, -(10 ** 6)],
                   np.int32)
    got = gather_patches(torch.from_numpy(padded), torch.from_numpy(idx),
                         cols=cols, w=w).numpy()
    want = np.asarray(jax_gather_patches(jnp.asarray(padded),
                                         jnp.asarray(idx), cols=cols, w=w))
    assert got.tobytes() == want.tobytes()


def test_cpu_tensors_take_the_plain_path(rng):
    padded = torch.from_numpy(_scene(rng, 16, 16, 4, 8, 0))
    idx = torch.from_numpy(rng.integers(0, 256, 21).astype(np.int32))
    before = (gather_patches_f32.launches, gather_patches_bf16.launches)
    want = gather_patches(padded, idx, cols=16, w=8)
    assert torch.equal(gather_patches_f32(padded, idx, cols=16, w=8), want)
    assert torch.equal(
        gather_patches_bf16(padded.to(torch.bfloat16), idx, cols=16, w=8),
        gather_patches(padded.to(torch.bfloat16), idx, cols=16, w=8))
    assert (gather_patches_f32.launches,
            gather_patches_bf16.launches) == before == (0, 0)


def test_wrappers_reject_bad_inputs(rng):
    padded = torch.from_numpy(_scene(rng, 16, 16, 4, 8, 0))
    idx = torch.arange(5, dtype=torch.int32)
    with pytest.raises(TypeError):
        gather_patches_f32(padded, idx.long(), cols=16, w=8)
    with pytest.raises(TypeError):
        gather_patches_f32(padded.to(torch.bfloat16), idx, cols=16, w=8)
    with pytest.raises(TypeError):
        gather_patches_bf16(padded, idx, cols=16, w=8)
    with pytest.raises(ValueError):
        gather_patches_f32(padded, idx, cols=16, w=40)
    with pytest.raises(ValueError):
        gather_patches_f32(padded[0], idx, cols=16, w=8)


def test_gather_spectra(rng):
    spectra = rng.normal(size=(50, 7)).astype(np.float32)
    idx = rng.integers(0, 50, 13).astype(np.int32)
    got = gather_spectra(torch.from_numpy(spectra), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), spectra[idx])


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
