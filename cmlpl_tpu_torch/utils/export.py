"""Ahead-of-time export of the whole-scene predictor
(``cmlpl_tpu/utils/export.py:46-155, 353-449``).

The trained weights are baked into the whole-scene predictor, which is
captured with ``torch.export`` as one program of the signature

    f(padded_cube (Hp, Wp, n_pc) f32, spectra (K, bands) f32) -> (K,) int32

with 0-based class ids, fixed to the scene's geometry.  Anyone can then map
the scene without the model code or the checkpoint format.

Two containers, as in the JAX package:

- the artifact, a zip of ``meta.json`` (geometry, gather mode, platform,
  compute dtype, torch version) and ``model.pt2`` (the bytes of
  ``torch.export.save``), loaded by :func:`load_exported` in any Python
  with torch;
- the native bundle (:func:`save_native_bundle`), a directory of an
  AOTInductor package ``model.pt2`` compiled for the export device,
  ``signature.txt`` and ``meta.json``, run with no Python by
  ``native/aoti_host.cpp``.

Gather modes: ``xla`` (the tiled map over the plain gather, its tile loop
one ``while_loop`` operator, so the graph holds one copy of the net) and
``dense`` (the dilated whole-scene pass).  The CUDA kernel modes
are refused: the port's kernels are ``ctypes`` launches, which
``torch.export`` cannot capture, as the JAX package refuses its Pallas
modes.

A program holds its weights on one device, so an artifact is for one
platform, ``cuda`` or ``cpu``: an input on another device is refused.
The TF32 switches that the model's ``compute_precision`` sets are process
state, not ops of the graph, so the export, the compile and every run take
them from ``meta["compute_dtype"]``.
"""

from __future__ import annotations

import copy
import io
import json
import os
import subprocess
import tempfile
import zipfile
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from cmlpl_tpu_torch.data.patches import gather_patches, gather_spectra
from cmlpl_tpu_torch.data.prep import PreparedScene
from cmlpl_tpu_torch.device import compute_precision
from cmlpl_tpu_torch.eval.inference import _dense_logits, _dense_params_view

FORMAT_VERSION = 1
#: the gather modes an artifact can hold
EXPORT_GATHERS = ("xla", "dense")
#: signature names of the program's arguments and result
IN_NAMES = ("padded_cube", "spectra")
OUT_NAME = "labels"

_NATIVE_DTYPES = {torch.float32: "f32", torch.int32: "i32",
                  torch.bfloat16: "bf16", torch.uint8: "u8",
                  torch.uint32: "u32"}


class _TiledScene(nn.Module):
    """The tiled map (``_tiled_scene_fn``, ``:46-78``): pixel ids cut into
    tiles, the last padded with id 0, one loop over the tiles of gather,
    forward pass and argmax, then the first K labels.

    The loop is a functional ``while_loop`` carrying the tile number and
    the labels, so the graph holds the net once (a Python loop would trace
    a net a tile).  ``torch._higher_order_ops.map``, JAX's ``lax.map``,
    exports on torch 2.13 but not on 2.11, whose AOTInductor cannot
    compile its lowering either."""

    def __init__(self, model: nn.Module, scene: PreparedScene, tile: int):
        super().__init__()
        self.model = model
        self.cols, self.w = scene.cols, scene.patch_size
        self.k = scene.num_pixels
        padded_k = -(-self.k // tile) * tile
        idx = np.arange(padded_k, dtype=np.int32)
        idx[self.k:] = 0  # padding pixels classify pixel 0; cut below
        self.register_buffer("idx_tiles",
                             torch.from_numpy(idx.reshape(-1, tile)))

    def _tile(self, ids, padded, spectra):
        xp = gather_patches(padded, ids, cols=self.cols, w=self.w)
        out = self.model(xp, gather_spectra(spectra, ids))
        logits = out[0] if isinstance(out, (tuple, list)) else out
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def forward(self, padded, spectra):
        from torch._higher_order_ops.while_loop import while_loop

        tiles = self.idx_tiles

        def cond(i, labels):
            return i[0] < tiles.shape[0]

        def body(i, labels):
            ids = tiles.index_select(0, i).reshape(-1)
            tile_labels = self._tile(ids, padded, spectra)
            return i + 1, labels.index_copy(0, i, tile_labels[None])

        start = torch.zeros(1, dtype=torch.int64, device=tiles.device)
        labels = torch.zeros(tiles.shape, dtype=torch.int32,
                             device=tiles.device)
        _, labels = while_loop(cond, body, (start, labels))
        return labels.reshape(-1)[:self.k]


class _DenseScene(nn.Module):
    """The dense map (``_dense_scene_fn``, ``:81-97``)."""

    def __init__(self, params: Mapping, scene: PreparedScene):
        super().__init__()
        if scene.patch_size % 4 != 0:
            raise ValueError("dense export needs patch_size % 4 == 0 "
                             f"(got {scene.patch_size})")
        view = _dense_params_view(params)
        self.names = list(view)
        for i, name in enumerate(self.names):
            self.register_buffer(f"p{i}", view[name].detach().float())
        self.rows, self.cols = scene.rows, scene.cols
        self.w = scene.patch_size

    def forward(self, padded, spectra):
        view = {n: getattr(self, f"p{i}") for i, n in enumerate(self.names)}
        logits = _dense_logits(view, padded, spectra, self.rows, self.cols,
                               self.w)
        return torch.argmax(logits, dim=-1).to(torch.int32)


def build_exported(model: Optional[nn.Module], params: Optional[Mapping],
                   scene: PreparedScene, *, gather: str = "xla",
                   tile: int = 4096, device=None,
                   extra_meta: Optional[dict] = None):
    """Trace the whole-scene predictor.  Returns ``(meta,
    torch.export.ExportedProgram)``; the program feeds both the zip
    artifact (:func:`save_exported`) and the native bundle
    (:func:`save_native_bundle`).

    ``model``: the net of the ``xla`` mode, ``model(xp, x)`` giving the
    logits or a tuple that starts with them (a BaseNet2).  ``params``: the
    ``state_dict`` of the ``dense`` mode (BaseNet2- or CCT-shaped; default
    ``model.state_dict()``).  ``device``: where the program's weights live
    and it runs, default the scene's device.
    """
    if gather not in EXPORT_GATHERS:
        raise ValueError(
            f"gather={gather!r} cannot be exported: the CUDA kernel modes "
            "are ctypes launches (ops/_build.py), which torch.export cannot "
            f"capture; use one of {EXPORT_GATHERS}")
    device = torch.device(device) if device is not None else scene.device
    if gather == "dense":
        if params is None:
            if model is None:
                raise ValueError("gather='dense' needs params or a model")
            params = model.state_dict()
        fn, precision = _DenseScene(params, scene), "float32"
    else:
        if model is None:
            raise ValueError("gather='xla' needs the model")
        fn = _TiledScene(copy.deepcopy(model), scene, tile)
        precision = getattr(model, "precision", "float32")
    fn = fn.to(device).eval()
    args = (scene.padded_pca.to(device), scene.spectra.to(device))
    with compute_precision(precision), torch.no_grad():
        exported = torch.export.export(fn, args)
    meta = {
        "format_version": FORMAT_VERSION,
        "rows": scene.rows, "cols": scene.cols,
        "num_pixels": scene.num_pixels,
        "n_pc": scene.n_pc, "patch_size": scene.patch_size,
        "cube_shape": list(scene.padded_pca.shape),
        "spectra_shape": list(scene.spectra.shape),
        "gather": gather, "tile": tile,
        "platforms": [device.type],
        "torch_version": torch.__version__,
        "compute_dtype": precision,
    }
    if extra_meta:
        meta.update(extra_meta)
    return meta, exported


def serialize(exported) -> bytes:
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def export_scene_predictor(model, params, scene: PreparedScene, *,
                           gather: str = "xla", tile: int = 4096,
                           device=None, extra_meta: Optional[dict] = None):
    """Serialise the whole-scene predictor.  Returns ``(meta, payload)``,
    the payload the bytes of ``torch.export.save``."""
    meta, exported = build_exported(model, params, scene, gather=gather,
                                    tile=tile, device=device,
                                    extra_meta=extra_meta)
    return meta, serialize(exported)


def save_exported(path: str, meta: dict, payload: bytes) -> None:
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        z.writestr("model.pt2", payload)


def _load_raw(path: str):
    """meta + the raw ``ExportedProgram`` (tests, introspection)."""
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        return meta, torch.export.load(io.BytesIO(z.read("model.pt2")))


def read_meta(path: str) -> dict:
    with zipfile.ZipFile(path) as z:
        return json.loads(z.read("meta.json"))


def load_exported(path: str, device=None):
    """Load an artifact: returns ``(meta, fn)`` where ``fn(padded_cube,
    spectra)`` gives the (num_pixels,) int32 labels as a NumPy array.

    ``device``: where to run (default: the artifact's platform; a card's
    index may be named, ``cuda:1``); another platform than the
    artifact's is refused, as is a tensor input on another device: the
    program's weights live on that platform.  NumPy inputs are placed on
    ``device``.  The run takes the TF32 switches from the meta's compute
    dtype."""
    meta, exported = _load_raw(path)
    platform = meta["platforms"][0]
    device = torch.device(platform if device is None else device)
    if device.type != platform:
        raise ValueError(f"the artifact runs on {platform}, not on "
                         f"{device}")
    program = exported.module()

    def fn(padded, spectra):
        args = []
        for name, a in zip(IN_NAMES, (padded, spectra)):
            if isinstance(a, torch.Tensor):
                if a.device.type != device.type:
                    raise ValueError(
                        f"{name} is on {a.device}, the artifact runs on "
                        f"{device.type}")
            else:
                a = torch.as_tensor(np.asarray(a), device=device)
            args.append(a)
        with compute_precision(meta["compute_dtype"]), torch.no_grad():
            out = program(*args)
        return out.cpu().numpy()

    return meta, fn


def signature_lines(exported) -> list[str]:
    """``input|output <name> <dtype> <dims|->`` lines of the program, the
    grammar of ``cmlpl_tpu/native/pjrt_host.cc``'s ``signature.txt``."""
    specs = exported.graph_signature.user_inputs
    nodes = {n.name: n for n in exported.graph.nodes if n.op == "placeholder"}
    ins = [nodes[s].meta["val"] for s in specs]
    out_node = next(n for n in exported.graph.nodes if n.op == "output")
    outs = [a.meta["val"] for a in out_node.args[0]]
    if len(ins) != len(IN_NAMES) or len(outs) != 1:
        raise ValueError("signature name count mismatch")

    def line(kind, name, t):
        dt = _NATIVE_DTYPES.get(t.dtype)
        if dt is None:
            raise ValueError(f"unsupported dtype {t.dtype} for {name}")
        dims = ",".join(str(int(d)) for d in t.shape)
        return f"{kind} {name} {dt} {dims or '-'}"

    return ([line("input", n, t) for n, t in zip(IN_NAMES, ins)]
            + [line("output", OUT_NAME, outs[0])])


def inductor_cxx() -> str:
    """The C++ compiler that AOTInductor links its package with: the first
    of ``$CXX`` and the ``g++`` and ``c++`` of each ``PATH`` directory that
    links a shared object with ``-fopenmp``, as Inductor's wrapper is
    linked.  Raises RuntimeError when none can."""
    cands = [os.environ["CXX"]] if os.environ.get("CXX") else []
    for d in os.environ.get("PATH", "").split(os.pathsep):
        for name in ("g++", "c++"):
            path = os.path.join(d, name)
            if os.access(path, os.X_OK) and path not in cands:
                cands.append(path)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cpp")
        with open(src, "w") as f:
            f.write("int probe() { return 0; }\n")
        for cxx in cands:
            proc = subprocess.run(
                [cxx, "-fopenmp", "-shared", "-fPIC", src, "-o",
                 os.path.join(tmp, "probe.so")], capture_output=True)
            if proc.returncode == 0:
                return cxx
    raise RuntimeError(f"no C++ compiler of {cands} links with -fopenmp, "
                       "which AOTInductor's package needs")


def save_native_bundle(dir_path: str, meta: dict, exported) -> str:
    """Write the native runner's bundle (``native/aoti_host.cpp``):

    - ``model.pt2``      an AOTInductor package of the program, compiled
      for its platform under the meta's compute precision;
    - ``signature.txt``  one ``input|output <name> <dtype> <dims>`` line
      per argument, the JAX bundle's grammar;
    - ``meta.json``      the artifact's metadata (its platform and compute
      dtype are what the runner reads).

    There is no ``compile_options.pb``: PJRT needs it, AOTInductor does
    not.  Returns the package's path."""
    import torch._inductor

    os.makedirs(dir_path, exist_ok=True)
    sig = signature_lines(exported)
    package = os.path.join(os.path.abspath(dir_path), "model.pt2")
    # no buffer reuse: torch 2.11's Inductor fails its reuse planning
    # inside the tile loop's body ("End index out of bounds")
    options = {"cpp.cxx": (None, inductor_cxx()),
               "allow_buffer_reuse": False}
    with (compute_precision(meta["compute_dtype"]),
          torch._inductor.config.patch(options)):
        torch._inductor.aoti_compile_and_package(exported,
                                                 package_path=package)
    with open(os.path.join(dir_path, "signature.txt"), "w") as f:
        f.write("\n".join(sig) + "\n")
    with open(os.path.join(dir_path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return package
