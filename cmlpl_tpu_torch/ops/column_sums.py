"""Column sums in NumPy's order: the CUDA kernel, its wrapper and the plain
PyTorch version it is held against.

For a C-ordered (n, cols) float32 or float64 tensor ``x`` every function
here returns, in ``x``'s dtype,

    out[j] = ((0 + x[0, j]) + x[1, j]) + ... + x[n - 1, j]

each add rounded on its own, which is what NumPy's ``x.sum(0)`` gives for
a C-ordered array of two or more columns (it adds row after row; a single
column it adds pairwise).  Given ``centre`` (cols,), the sums are of the
squared deviations ``d * d``, ``d = x[i] - centre``, each ``d`` and each
square rounded before the add, as ``np.var`` forms them.  The device prep
(``data/prep.py``) takes its column means and standard deviations from
these sums, so that they equal the host prep's bit for bit.

The kernel, :func:`column_sums_seq`, is ``csrc/column_sums.cu`` (its header
says what bounds it: the chain of n dependent adds a column).  Given CPU
tensors the wrapper runs the plain version, :func:`column_sums_plain`, an
explicit loop over the rows; given CUDA tensors it launches the kernel or
raises.  ``column_sums_seq.launches`` counts the launches.
"""

from __future__ import annotations

import torch

from cmlpl_tpu_torch.ops import _build

#: the C entry point of each dtype
_ENTRY = {torch.float32: "cmlpl_column_sums_seq_f32",
          torch.float64: "cmlpl_column_sums_seq_f64"}


def _check(x: torch.Tensor, centre: torch.Tensor | None) -> None:
    if x.dtype not in _ENTRY:
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"x must be (rows >= 1, cols), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if centre is None:
        return
    if centre.dtype != x.dtype:
        raise TypeError(f"centre must be {x.dtype}, got {centre.dtype}")
    if centre.shape != x.shape[1:]:
        raise ValueError(f"centre must be ({x.shape[1]},), got "
                         f"{tuple(centre.shape)}")
    if centre.device != x.device:
        raise ValueError(f"centre on {centre.device}, x on {x.device}")
    if not centre.is_contiguous():
        raise ValueError("centre must be contiguous")


def column_sums_plain(x: torch.Tensor,
                      centre: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: the column sums (of squared deviations from
    ``centre``, when given), one row at a time."""
    acc = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
    for row in x:
        if centre is not None:
            row = row - centre
            row = row * row
        acc = acc + row
    return acc


def column_sums_seq(x: torch.Tensor,
                    centre: torch.Tensor | None = None) -> torch.Tensor:
    """(cols,) sums of ``x``'s columns in row order, in ``x``'s dtype (of
    its squared deviations from ``centre``, when given)."""
    _check(x, centre)
    if x.device.type == "cpu":
        return column_sums_plain(x, centre)
    n, cols = x.shape
    if cols >= 2 ** 31:
        raise ValueError(f"{cols} columns exceed the kernel's 32-bit grid")
    out = torch.empty(cols, dtype=x.dtype, device=x.device)
    fn_name = _ENTRY[x.dtype]
    fn = getattr(_build.library(), fn_name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), None if centre is None else centre.data_ptr(),
                 out.data_ptr(), n, cols, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError_t {err}")
    column_sums_seq.launches += 1
    return out


column_sums_seq.launches = 0
