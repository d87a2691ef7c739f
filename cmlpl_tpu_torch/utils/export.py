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
``dense`` (the dilated whole-scene pass).  The map's CUDA kernel modes
are refused, as the JAX package refuses its Pallas modes: the map
launches its kernel through ``ctypes``, which ``torch.export`` cannot
capture.  The training run's per-step kernel gathers are exported, as
their ``cmlpl`` operators (:func:`build_run_exported`).

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
from cmlpl_tpu_torch.weights import StateTree

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


def signature_lines(exported, in_names=IN_NAMES,
                    out_names=(OUT_NAME,)) -> list[str]:
    """``input|output <name> <dtype> <dims|->`` lines of the program, the
    grammar of ``cmlpl_tpu/native/pjrt_host.cc``'s ``signature.txt``, for
    its arguments and results named ``in_names`` and ``out_names``."""
    specs = exported.graph_signature.user_inputs
    nodes = {n.name: n for n in exported.graph.nodes if n.op == "placeholder"}
    ins = [nodes[s].meta["val"] for s in specs]
    out_node = next(n for n in exported.graph.nodes if n.op == "output")
    outs = [a.meta["val"] for a in out_node.args[0]]
    if len(ins) != len(in_names) or len(outs) != len(out_names):
        raise ValueError("signature name count mismatch")

    def line(kind, name, t):
        dt = _NATIVE_DTYPES.get(t.dtype)
        if dt is None:
            raise ValueError(f"unsupported dtype {t.dtype} for {name}")
        dims = ",".join(str(int(d)) for d in t.shape)
        return f"{kind} {name} {dt} {dims or '-'}"

    return ([line("input", n, t) for n, t in zip(in_names, ins)]
            + [line("output", n, t) for n, t in zip(out_names, outs)])


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


def save_native_bundle(dir_path: str, meta: dict, exported, *,
                       in_names=IN_NAMES, out_names=(OUT_NAME,)) -> str:
    """Write the native runner's bundle (``native/aoti_host.cpp``):

    - ``model.pt2``      an AOTInductor package of the program, compiled
      for its platform under the meta's compute precision;
    - ``signature.txt``  one ``input|output <name> <dtype> <dims>`` line
      per argument and result (``in_names``, ``out_names``), the JAX
      bundle's grammar;
    - ``meta.json``      the artifact's metadata (its platform and compute
      dtype are what the runner reads).

    There is no ``compile_options.pb``: PJRT needs it, AOTInductor does
    not.  Returns the package's path."""
    import torch._inductor

    os.makedirs(dir_path, exist_ok=True)
    sig = signature_lines(exported, in_names, out_names)
    package = os.path.join(os.path.abspath(dir_path), "model.pt2")
    # no buffer reuse: torch 2.11's Inductor fails its reuse planning
    # inside a while_loop's body ("End index out of bounds")
    options = {"cpp.cxx": (None, inductor_cxx()),
               "allow_buffer_reuse": False}
    if "bfloat16" in (meta["compute_dtype"], meta.get("model_dtype")):
        # round a fused bf16 chain at every op, as eager does, so that the
        # package maps as the in-process model does (a fusion that rounds
        # once at its end moves ties)
        options["emulate_precision_casts"] = True
    with (compute_precision(meta["compute_dtype"]),
          torch._inductor.config.patch(options)):
        torch._inductor.aoti_compile_and_package(exported,
                                                 package_path=package)
    with open(os.path.join(dir_path, "signature.txt"), "w") as f:
        f.write("\n".join(sig) + "\n")
    with open(os.path.join(dir_path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return package


# --------------------------------------------------------------------------
# the training-run bundle (``cmlpl_tpu/utils/export.py:183-350``)
# --------------------------------------------------------------------------

#: the run program's inputs after the state's leaves, in order: the scene,
#: the pool, the (E, N, B) schedule (then a trainer's ``extra0``, ...); a
#: per-step gather's program has no pool, and its ids are pixel ids
RUN_INPUTS = ("padded_pca", "spectra", "pool_idx", "lab_idx", "lab_y",
              "unl_idx")
RUN_INPUTS_PER_STEP = tuple(n for n in RUN_INPUTS if n != "pool_idx")


def _canonical(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with the contiguous strides of its shape, size-1
    dims included: a ``while_loop`` requires each carried tensor to come
    back with the strides it went in with, and the strides a traced op
    gives a size-1 dim are its meta function's choice."""
    return t.clone(memory_format=torch.contiguous_format)


def _reshape_views(gm: torch.fx.GraphModule) -> torch.fx.GraphModule:
    """Turn the traced step's ``view`` nodes into ``reshape``.  ``make_fx``
    records a ``reshape`` as a ``view`` where the traced strides allow it;
    torch 2.11's Dynamo re-traces a ``while_loop`` body with symbolic
    shapes, whose strides may not (a pooled activation of the card's
    channels-last convolutions), and refuses the view.  The values are the
    same: the step mutates nothing in place."""
    for node in gm.graph.nodes:
        if node.op == "call_function" and node.target in (
                torch.ops.aten.view.default,
                torch.ops.aten._unsafe_view.default):
            node.target = torch.ops.aten.reshape.default
    gm.recompile()
    return gm


def _lift_constants(gm: torch.fx.GraphModule):
    """The tensor constants that ``make_fx`` stored on ``gm`` (``get_attr``
    nodes) turned into trailing inputs of the graph; returns (the graph,
    the constants in the order of those inputs).  A loop body that reads a
    tensor attribute keeps the value its export traced with, a fake
    tensor; an input is the run program's buffer, passed in."""
    inputs = {}         # attribute name -> (its placeholder, its value)
    last = [n for n in gm.graph.nodes if n.op == "placeholder"][-1]
    for node in list(gm.graph.nodes):
        if node.op != "get_attr" or not isinstance(
                getattr(gm, node.target, None), torch.Tensor):
            continue
        if node.target not in inputs:
            with gm.graph.inserting_after(last):
                last = gm.graph.placeholder(f"step_const{len(inputs)}")
            inputs[node.target] = last, getattr(gm, node.target)
        node.replace_all_uses_with(inputs[node.target][0])
        gm.graph.erase_node(node)
    for target in inputs:
        delattr(gm, target)
    gm.recompile()
    return gm, [value for _, value in inputs.values()]


def _trace_step(step, layout, example, *, batches: int, with_thr: bool):
    """``make_fx`` of the step at loop iteration ``i``: row ``i`` of the
    flat schedule, epoch ``i // N``, batch index ``i % N``; returns the
    new state (all but the key, each canonical) and the metrics in sorted
    order, as JAX flattens the metrics dict.  Traced with real tensors
    (``example``: ``i``, the state, then the key, the pooled sources, the
    flat schedule and the threshold table), so the step runs once.
    Returns ((the graph, its tensor constants: :func:`_lift_constants`),
    the metric names)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    n = len(layout.leaves) - 1
    rng_at = [lf.kind for lf in layout.leaves].index("rng")
    names = []

    def iteration(i, *args):
        state = list(args[:n])
        key, xp_src, x_src, li, ly, ui, thr_table = args[n:]
        epoch, b = i // batches, i % batches
        thr = (thr_table.index_select(0, epoch.reshape(1)).reshape(())
               if with_thr else None)
        state.insert(rng_at, key)
        row = i.reshape(1)
        new, metrics = step(state, xp_src, x_src,
                            *(a.index_select(0, row).reshape(-1)
                              for a in (li, ly, ui)), epoch, b, thr)
        new.pop(rng_at)
        names[:] = sorted(metrics)
        return (*(_canonical(t) for t in new),
                *(metrics[k] for k in names))

    gm = make_fx(iteration, tracing_mode="real")(*example)
    return _lift_constants(_reshape_views(gm)), list(names)


def _run_sources(layout, inputs, *, cast, prep_cube, cols: int, w: int,
                 with_thr: bool):
    """(the state in the step's layout without the key, the constants of
    every step: the key, the step's sources, the flat (E·N, B) schedule,
    the threshold table), from the run's inputs.  The sources are the
    pooled patches and spectra, gathered once by the plain gather; or,
    with ``prep_cube`` (a per-step gather's, ``make_train_gather``), the
    prepared cube and the spectra in the input dtype, prepared once a
    run, as JAX's ``prep_cube`` runs once a dispatch."""
    n = len(layout.leaves)
    state = [_canonical(t) for t in layout.to_torch(inputs[:n])]
    key = state.pop([lf.kind for lf in layout.leaves].index("rng"))
    padded, spectra, *rest = inputs[n:]
    if prep_cube is None:
        pool_idx, *rest = rest
        xp_src = gather_patches(cast(padded), pool_idx, cols=cols, w=w)
        x_src = cast(gather_spectra(spectra, pool_idx))
    else:
        xp_src, x_src = prep_cube(padded), cast(spectra)
    li, ly, ui = rest[:3]
    thr = rest[3] if with_thr else torch.zeros(1, device=li.device)
    flat = (a.reshape(li.shape[0] * li.shape[1], -1) for a in (li, ly, ui))
    return state, (key.to(torch.int64), xp_src, x_src, *flat, thr)


class _RunProgram(nn.Module):
    """The whole training run as one program of the JAX bundle's
    signature: the state's leaves (flax layout), the scene, the pool and
    the schedule, and CMLPL's per-epoch threshold in; the final leaves and
    every metric stacked (E, N) out.

    The pool is gathered once by the plain gather (the JAX run program's
    bulk gather is the plain gather too).  A per-step gather's program
    has no pool: each step gathers at its ids, by the plain gather
    ("xla") or by a kernel's operator ("pallas", "pallas_bf16": two
    ``cmlpl::gather_patches_*`` nodes a step), as the JAX non-pool run
    gathers by its Pallas kernel.  The E·N steps are one functional
    ``while_loop`` carrying the state (step layout, all but the key) and
    the metric buffers; the step is ``step_graph``,
    :class:`~cmlpl_tpu_torch.train.functional.RunStep` traced once
    (:func:`_trace_step`) with ``metrics`` metrics.  ``sources``: the
    keywords of :func:`_run_sources`."""

    def __init__(self, layout, step_graph, metrics: int, sources: dict):
        super().__init__()
        self.layout = layout
        self.step_graph, step_consts = step_graph
        for i, t in enumerate(step_consts):
            self.register_buffer(f"step_const{i}", t)
        self.step_consts = len(step_consts)
        self.metrics = metrics
        self.sources = sources

    def forward(self, *inputs):
        from torch._higher_order_ops.while_loop import while_loop_op

        state, consts = _run_sources(self.layout, inputs, **self.sources)
        consts = (*consts, *(getattr(self, f"step_const{i}")
                             for i in range(self.step_consts)))
        n, m = len(state), self.metrics
        steps = consts[3].shape[0]
        bufs = [torch.zeros(steps, device=consts[0].device)
                for _ in range(m)]

        def cond(i, *args):
            return i < steps

        def body(i, *args):
            carry, acc, fixed = args[:n], args[n:n + m], args[n + m:]
            out = self.step_graph(i, *carry, *fixed)
            row = i.reshape(1)
            return (i + 1, *out[:n],
                    *(buf.index_copy(0, row, v.reshape(1))
                      for buf, v in zip(acc, out[n:])))

        # the loop operator itself, its constants passed in: ``while_loop``
        # would first re-trace the step graph with Dynamo, which costs the
        # export most of its time and adds nothing to a graph that
        # ``make_fx`` already traced
        start = torch.zeros((), dtype=torch.int64, device=consts[0].device)
        out = while_loop_op(cond, body, (start, *state, *bufs),
                            tuple(consts))[1:]
        state = list(out[:n])
        rng_at = [lf.kind for lf in self.layout.leaves].index("rng")
        state.insert(rng_at, inputs[rng_at].clone())
        # lab_idx's (E, N): it follows the leaves, the scene and any pool
        shape = inputs[n + 3 + (self.sources["prep_cube"] is None)].shape[:2]
        return (*self.layout.to_jax(state),
                *(m.reshape(shape) for m in out[n:]))


def build_run_exported(trainer, scene: PreparedScene, sampler, seed, *,
                       platform: Optional[str] = None):
    """Export ``trainer``'s WHOLE training run at its config as one
    ``torch.export`` program, the JAX bundle's native-training contract.

    The initial state is ``trainer.init_state(seed)`` (``cli.train``'s
    serial run ``(seed, 0)`` when ``seed`` is that pair) and the run's key
    ``core/rng.seed_key(seed)``; the schedule is drawn from ``sampler`` as
    ``train_run`` draws it and, in pool mode, pooled
    (``poolify_batches``).  The draws of each step come from that key and
    the step number inside the program (``core/rng.CounterStream``).
    ``platform`` ("cuda" or "cpu", default the trainer's device) must be
    the trainer's device type.

    The trainer's resolved ``gather_impl`` sets the program: "pool" (the
    JAX pool bundle's inputs, :data:`RUN_INPUTS`), or a per-step gather,
    "xla", "pallas" or "pallas_bf16" (the JAX non-pool bundle's,
    :data:`RUN_INPUTS_PER_STEP`: pixel ids and no pool), whose kernel
    modes hold their ``cmlpl::gather_patches_*`` operator, named in
    ``meta["custom_ops"]``.

    Returns ``(meta, exported, inputs)``: ``inputs`` the ordered
    ``{name: numpy array}`` of the program's arguments, named as the JAX
    bundle names them (``state.<path>`` in the flax layout, then the
    scene and schedule and ``extra0``), so either package's program takes
    the same ``inputs/`` directory."""
    from cmlpl_tpu_torch.core.rng import seed_key
    from cmlpl_tpu_torch.ops.patch_gather import poolify_batches
    from cmlpl_tpu_torch.train.driver import stack_schedule
    from cmlpl_tpu_torch.train.functional import RunStep, StateLayout

    cfg = trainer.config
    device = trainer.device
    if platform is not None and torch.device(platform).type != device.type:
        raise ValueError(f"a {platform} program needs a trainer on "
                         f"{platform}, not on {device}")
    pool_mode = cfg.gather_impl == "pool"
    state = trainer.init_state(seed)
    layout = StateLayout(trainer, state, seed_key(seed))
    step = RunStep(trainer, state, layout, cols=scene.cols)

    li, ly, ui = stack_schedule(sampler, cfg.num_epochs)
    scene_and_schedule = [scene.padded_pca.cpu().numpy(),
                          scene.spectra.cpu().numpy()]
    if pool_mode:
        pool, li, ui = poolify_batches(li, ui)
        scene_and_schedule.append(pool)
    scene_and_schedule += [li, np.asarray(ly, np.int32), ui]
    extras = [np.asarray(e) for e in trainer._run_extras()]
    inputs = dict(zip(layout.names, layout.values))
    inputs.update(zip(RUN_INPUTS if pool_mode else RUN_INPUTS_PER_STEP,
                      scene_and_schedule))
    inputs.update({f"extra{i}": e for i, e in enumerate(extras)})
    with_thr = bool(extras)
    b = li.shape[1]

    args = tuple(torch.from_numpy(np.array(v)).to(device)
                 for v in inputs.values())
    sources = dict(cast=trainer.cast,
                   prep_cube=None if pool_mode else trainer._prep_cube,
                   cols=scene.cols, w=cfg.patch_size, with_thr=with_thr)
    with compute_precision("float32"):
        state_t, consts = _run_sources(layout, args, **sources)
        i0 = torch.zeros((), dtype=torch.int64, device=device)
        graph, names = _trace_step(step, layout, (i0, *state_t, *consts),
                                   batches=b, with_thr=with_thr)
        program = _RunProgram(layout, graph, len(names), sources)
        exported = torch.export.export(program, args)
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "train_run",
        "trainer": type(trainer).__name__,
        "num_epochs": cfg.num_epochs,
        "batches_per_epoch": int(b),
        "gather_impl": cfg.gather_impl,
        "rng_impl": cfg.rng_impl,
        "input_names": list(inputs),
        "output_names": layout.names + [f"metrics.{m}" for m in names],
        "platforms": [device.type],
        "torch_version": torch.__version__,
        # the program's f32 work (losses, queues, Adam) runs with TF32 off
        # under either model dtype, as the eager steps do; a bf16 model's
        # layers are bf16 ops of the graph
        "compute_dtype": "float32",
        "model_dtype": cfg.compute_dtype,
        # the operators the package calls by name: the runner loads
        # their library first (native/aoti_host.cpp --op_library)
        "custom_ops": _custom_ops(exported),
    }
    return meta, exported, inputs


def _custom_ops(exported) -> list[str]:
    """The ``cmlpl`` operators that ``exported``'s graph calls, its
    loops' bodies included, by qualified name (``cmlpl::<name>``)."""
    from cmlpl_tpu_torch.ops.patch_gather import OP_NAMESPACE

    found = set()
    for module in exported.graph_module.modules():
        if not isinstance(module, torch.fx.GraphModule):
            continue
        for node in module.graph.nodes:
            target = node.target
            if (node.op == "call_function"
                    and isinstance(target, torch._ops.OpOverload)
                    and target.namespace == OP_NAMESPACE):
                found.add(target._schema.name)
    return sorted(found)


def save_run_bundle(dir_path: str, meta: dict, exported, inputs) -> str:
    """The training bundle: :func:`save_native_bundle`'s ``model.pt2``,
    ``signature.txt`` (every input and output by name) and ``meta.json``,
    and ``inputs/<name>.npy``, one file per input, everything the native
    runner needs to train:

        aoti_host --bundle DIR --inputs DIR/inputs --outdir OUT

    A bundle that calls a kernel's operator (``meta["custom_ops"]``) is
    for the card alone: the runner has no CPU kernel of it, and a plain
    gather there would hide the mode, so a ``cpu`` one is refused.

    Returns the package's path."""
    if meta.get("custom_ops") and meta["platforms"] != ["cuda"]:
        raise ValueError(
            f"gather_impl {meta['gather_impl']!r} runs "
            f"{', '.join(meta['custom_ops'])}, a CUDA kernel: its bundle "
            f"is for the cuda platform, not {meta['platforms']}")
    package = save_native_bundle(dir_path, meta, exported,
                                 in_names=meta["input_names"],
                                 out_names=meta["output_names"])
    idir = os.path.join(dir_path, "inputs")
    os.makedirs(idir, exist_ok=True)
    for name, value in inputs.items():
        np.save(os.path.join(idir, name + ".npy"), value)
    return package


def run_outputs_tree(bundle_dir: str, outdir: str):
    """A run's outputs (``<outdir>/<name>.npy``, one per signature output
    of the bundle) as (the state's JAX tree without the key, nested
    dicts; ``{metric: (E, N) array}``; the key)."""
    with open(os.path.join(bundle_dir, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("kind") != "train_run":
        raise ValueError(f"{bundle_dir} is not a training bundle")
    tree: dict = {}
    metrics, key = {}, None
    for name in meta["output_names"]:
        value = np.load(os.path.join(outdir, name + ".npy"))
        kind, _, path = name.partition(".")
        if kind == "metrics":
            metrics[path] = value
        elif path == "rng":
            key = value
        else:
            *nodes, leaf = path.split(".")
            node = tree
            for part in nodes:
                node = node.setdefault(part, {})
            node[leaf] = value
    return tree, metrics, key


def load_run_outputs(bundle_dir: str, outdir: str, trainer):
    """A native run's outputs as ``(state, metrics)``: the state of
    ``trainer`` (built by its ``state_from_jax``, so its generator is
    seeded as that seeds it) and ``{metric: (E, N) array}``."""
    tree, metrics, _ = run_outputs_tree(bundle_dir, outdir)
    return trainer.state_from_jax(StateTree(tree)), metrics
