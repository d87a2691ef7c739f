"""Build and launch the native runner (``aoti_host.cpp``;
``cmlpl_tpu/native/pjrt_launcher.py:59-213``).

The runner is a C++ program against the installed libtorch.  It is built
with ``g++`` at first use into ``cmlpl_tpu_torch/_build/`` (git-ignored),
named by a hash of the source and the flags, so an edited source or
another torch rebuilds and an unchanged one is found at once.  Include
paths, the C++ ABI and the libraries come from the installed torch; the
CUDA libraries are linked when that torch has CUDA.

    python -m cmlpl_tpu_torch.native.aoti_launcher --bundle DIR \
        --cube cube.npy --spectra spectra.npy --out labels.npy --repeat 5
    python -m cmlpl_tpu_torch.native.aoti_launcher --bundle TRAIN_DIR \
        --inputs TRAIN_DIR/inputs --outdir OUT
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import threading

from cmlpl_tpu_torch.ops._build import torch_cxx_flags, torch_libs

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "aoti_host.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

_lock = threading.Lock()


def build_command(out_path: str) -> list[str]:
    """The ``g++`` command that builds the runner into ``out_path``."""
    import torch

    return ["g++", "-O2", "-fPIC", *torch_cxx_flags(), SRC, "-o", out_path,
            # keep libtorch_cuda though no symbol of it is named: loading it
            # registers the CUDA backend
            *torch_libs(cuda=torch.version.cuda is not None), "-ldl"]


def _host_path() -> str:
    h = hashlib.sha256(" ".join(build_command("")).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"aoti_host_{h.hexdigest()[:16]}")


def build_host(force: bool = False) -> str:
    """Build the runner if its binary is missing (or ``force``); returns its
    path.  Raises RuntimeError with the compiler's output on failure."""
    path = _host_path()
    with _lock:
        if os.path.exists(path) and not force:
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run(build_command(tmp), capture_output=True,
                                  text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"cannot build {SRC}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                               f"{SRC}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
        return path


def _run(args: list[str], timeout: float | None) -> dict:
    """The runner on ``args``: its JSON line as a dict.  Raises
    RuntimeError with the runner's errors when it fails."""
    proc = subprocess.run([build_host(), *args], capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"aoti_host failed ({proc.returncode}):\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def run_host(bundle: str, cube_npy: str, spectra_npy: str, out_npy: str,
             *, repeat: int = 1, device: str = "cuda",
             timeout: float | None = None) -> dict:
    """One-shot native inference: the runner's JSON line (``load_ms``,
    ``run_ms_min``, ``run_ms_mean``, ``repeat``) as a dict.  Raises
    RuntimeError with the runner's errors when it fails."""
    return _run(["--bundle", bundle, "--cube", cube_npy, "--spectra",
                 spectra_npy, "--out", out_npy, "--repeat", str(repeat),
                 "--device", device], timeout)


def run_host_io(bundle: str, inputs_dir: str, outdir: str, *,
                repeat: int = 1, device: str = "cuda",
                timeout: float | None = None) -> dict:
    """A training bundle's run (``--inputs --outdir``): reads
    ``<inputs_dir>/<name>.npy`` for every signature input and writes
    ``<outdir>/<name>.npy`` for every output.  A bundle whose
    ``meta.json`` names ``custom_ops`` (a kernel gather's) runs with
    ``--op_library``, the operators' library (``ops/_build.op_library``,
    built at first use).  Returns the runner's JSON line (``load_ms``,
    ``run_ms_min``, ``run_ms_mean``, ``repeat``, ``num_inputs``,
    ``num_outputs``, ``device``) as a dict."""
    from cmlpl_tpu_torch.ops._build import op_library

    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(bundle, "meta.json")) as f:
        ops = json.load(f).get("custom_ops")
    extra = ["--op_library", op_library()] if ops else []
    return _run(["--bundle", bundle, "--inputs", inputs_dir, "--outdir",
                 outdir, "--repeat", str(repeat), "--device", device,
                 *extra], timeout)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bundle", required=True)
    p.add_argument("--cube")
    p.add_argument("--spectra")
    p.add_argument("--out", default="labels.npy")
    p.add_argument("--inputs", help="a training bundle's inputs directory "
                                    "(with --outdir, in place of --cube "
                                    "and --spectra)")
    p.add_argument("--outdir")
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.inputs or args.outdir:
        if not (args.inputs and args.outdir):
            p.error("--inputs and --outdir go together")
        result = run_host_io(args.bundle, args.inputs, args.outdir,
                             repeat=args.repeat, device=args.device)
    else:
        if not (args.cube and args.spectra):
            p.error("one-shot mode needs --cube and --spectra")
        result = run_host(args.bundle, args.cube, args.spectra, args.out,
                          repeat=args.repeat, device=args.device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
