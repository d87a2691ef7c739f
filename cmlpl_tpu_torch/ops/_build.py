"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``cmlpl_tpu_torch/_build/`` (git-ignored), named by a
hash of the sources and the flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing is built at import time: the first
call of :func:`library` builds, later calls return the loaded library.

:func:`op_library` builds the kernels' operators for a process with no
Python (``csrc/gather_ops.cpp``, ``TORCH_LIBRARY(cmlpl)``: the native
runner loads it before a package that calls them): ``g++`` against the
installed torch's headers and the CUDA toolkit's, linked to the kernel
library, into the same directory, named by a hash of its sources, its
command and the kernel library's name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# (cube, idx, out, batch, cube_rows, cube_cols, channels, cols, w, then the
# plan: path, group, rows_per_warp, grid; stream) -> cudaError_t
_GATHER = ((_P, _P, _P, ctypes.c_int64, _I, _I, _I, _I, _I,
            _I, _I, _I, _I, _P), _I)
# (x, centre or NULL, out, rows, cols, stream) -> cudaError_t
_COLUMN_SUMS = ((_P, _P, _P, ctypes.c_int64, _I, _P), _I)
#: C signature of every entry point: (argtypes, restype)
SIGNATURES = {"cmlpl_patch_gather_f32": _GATHER,
              "cmlpl_patch_gather_bf16": _GATHER,
              "cmlpl_column_sums_seq_f32": _COLUMN_SUMS,
              "cmlpl_column_sums_seq_f64": _COLUMN_SUMS}


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}: the CUDA kernels "
                           "need the CUDA toolkit (set CUDA_HOME)")
    return path


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libcmlpl_kernels_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, str]:
    """Compile the sources if their library is missing; returns the
    library's path and the compiler's report ("" when nothing was built)."""
    path = _library_path()
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cus = [s for s in sources() if s.endswith(".cu")]
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, *cus],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path, proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _lib = lib
        return _lib


OP_SOURCES = ("gather_ops.cpp", "gather_plan.h")


def torch_cxx_flags() -> list[str]:
    """``g++`` flags of a source that includes the installed torch's
    headers: its C++ standard, its C++ ABI and its include paths."""
    import inspect
    import re

    import torch
    from torch.utils import cpp_extension

    found = re.findall(r"-std=c\+\+(\d+)",
                       inspect.getsource(cpp_extension))
    std = f"-std=c++{max(found, key=int)}" if found else "-std=c++17"
    root = os.path.dirname(torch.__file__)
    return [std, "-D_GLIBCXX_USE_CXX11_ABI="
            f"{int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
            "-I", os.path.join(root, "include"),
            "-I", os.path.join(root, "include", "torch", "csrc", "api",
                               "include")]


def torch_libs(cuda: bool) -> list[str]:
    """Link flags of the installed torch's libraries (its CUDA ones when
    ``cuda``), with an rpath to them."""
    import torch

    lib = os.path.join(os.path.dirname(torch.__file__), "lib")
    libs = ["-ltorch", "-ltorch_cpu", "-lc10"]
    if cuda:
        libs += ["-ltorch_cuda", "-lc10_cuda"]
    return ["-L", lib, f"-Wl,-rpath,{lib}", "-Wl,--no-as-needed", *libs]


def op_library_command(out_path: str, kernels: str) -> list[str]:
    """The ``g++`` command that builds the operators into ``out_path``,
    linked to the kernel library at ``kernels``."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return ["g++", "-O2", "-fPIC", "-shared", *torch_cxx_flags(),
            "-I", os.path.join(cuda_home, "include"),
            os.path.join(CSRC, "gather_ops.cpp"), "-o", out_path, kernels,
            f"-Wl,-rpath,{BUILD_DIR}", *torch_libs(cuda=True)]


def _op_library_path(kernels: str) -> str:
    h = hashlib.sha256(" ".join(op_library_command("", kernels)).encode())
    for name in OP_SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libcmlpl_ops_{h.hexdigest()[:16]}.so")


def op_library() -> str:
    """The operator library's path, built (with the kernel library) if it
    is missing.  Raises RuntimeError with the compiler's output on
    failure."""
    kernels, _ = build()
    path = _op_library_path(kernels)
    with _lock:
        if os.path.exists(path):
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run(op_library_command(tmp, kernels),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                               f"the operators:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, path)
        return path
