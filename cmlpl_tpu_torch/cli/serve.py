"""Persistent serving loop: load a trained BaseNet2 (or zoo model) ONCE,
classify many scenes.

    python -m cmlpl_tpu_torch.cli.serve --dataID 1 --checkpoint_dir ./ckpt
    python -m cmlpl_tpu_torch.cli.serve --dataID 1 --weights w.npz
    python -m cmlpl_tpu_torch.cli.serve --dataID 1 --model dbda \
        --weights dbda.npz

Counterpart of ``cmlpl_tpu/cli/serve.py``: net ``--net`` (b or e) of the
latest checkpoint of ``--checkpoint_dir``, or ``--weights``.  ``--model``
serves any model of the comparison zoo from the ``--weights`` that
``train_backbone --weights_out`` wrote, at its own ``--w`` and ``--n_PC``
unless given (``_common.resolve_model``; DBDA: 9 x 9 patches of all the
bands), through the same loop, prep and tiled map.  Requests
stream in as JSON lines on stdin and results stream out as JSON lines on
stdout.

Request line:  {"cube": "scene.npy", "out": "map.svg", "id": "r1"}
  - ``cube``: path to a (rows, cols, bands) .npy raw cube, or omitted to
    use the registered dataset's .mat from --data_root.
  - ``out``: ``.svg`` renders the class map with the dataset palette;
    ``.npy`` saves the raw 0-based prediction vector.
Response line: {"id": "r1", "pixels": N, "latency_s": ..., "out": ...}
A request that fails gets {"id": ..., "error": "..."} and the loop goes on.

Each cube is prepared on the card (``prepare_scene(on_card=True)``: the
raw cube's upload, then its PCA and z-scores there); the warm-up prepares
an f32 and an f64 cube, so that each dtype's kernels are loaded before
the first request.

``latency_s`` runs from reading the request to the map on the host, after
a device synchronise.  A scene whose dims differ from the previous
request's rebuilds the predictor for the new geometry.

``--multihost`` under ``torchrun`` (one process a card) maps each scene
in one strip a rank, as the JAX CLI maps over its local devices.  Rank 0
alone reads the weights, stdin and each request's cube, prepares the
scene, and writes the responses and the ``out`` files; the other ranks
write nothing to stdout (logs go to stderr), so a client reading
``torchrun``'s merged stdout sees the one-process protocol.  For each
request line rank 0 broadcasts a header, and every rank acts on it:

- ``map``: the prepared scene is broadcast
  (``core/mesh.broadcast_scene``, the span ``serve.broadcast``), each
  rank maps its strip (of tiles, or, dense, of scene rows) and the labels
  are gathered; rank 0 answers.
  Its ``latency_s`` includes the broadcast.
- ``error``: the request's JSON, its cube or its prep failed on rank 0
  (a cube that is not (rows, cols, the dataset's bands) is refused
  there), which answers ``{"id", "error"}``; the other ranks wait for the
  next header.
- ``stop``: rank 0 reached the end of stdin; every rank leaves the loop
  and passes a barrier, and ``main`` returns.

The warm-up map goes through the same broadcast on every rank, and rank
0 alone writes the ``ready`` line.  Over two or more ranks a fault
inside a rank's map is not caught: no partial map is answered, and the
world ends with a non-zero exit.  (One process, or a world of one,
answers it as an error, as before.)

    python -m torch.distributed.run --nproc_per_node 2 \
        -m cmlpl_tpu_torch.cli.serve --multihost --dataID 1 --weights w.npz
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import numpy as np

from cmlpl_tpu_torch.cli._common import (base_parser, build_model, logits_fn,
                                         resolve_model, setup_runtime, sync)
from cmlpl_tpu_torch.core.mesh import (barrier, broadcast_object,
                                       broadcast_scene, create_mesh,
                                       is_distributed, is_multiprocess,
                                       is_primary)
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.device import resolve_device
from cmlpl_tpu_torch.eval.inference import ScenePredictor
from cmlpl_tpu_torch.eval.visualize import save_class_map
from cmlpl_tpu_torch.registry import get_dataset
from cmlpl_tpu_torch.utils.profiling import span


def _error(req, e: Exception) -> dict:
    return {"id": req.get("id") if isinstance(req, dict) else None,
            "error": f"{type(e).__name__}: {e}"}


def main(argv=None, stdin=None, stdout=None):
    p = base_parser()
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the startup pass on the registered scene "
                        "geometry")
    args = p.parse_args(argv)
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    setup_runtime(args, file=sys.stderr)
    device = resolve_device(args.device)
    mesh = create_mesh(device) if args.multihost else None
    # a world of one has no peer to fall out of step with
    ranks = is_multiprocess(mesh)
    primary = mesh is None or is_primary(mesh)

    spec = get_dataset(args.dataID)
    entry = resolve_model(args, spec)
    model = build_model(args, spec, device, mesh)
    predictor = ScenePredictor(
        logits_fn(model, args.model), params=model.state_dict(),
        patch_size=args.w, cols=spec.cols, tile=args.val_batch_size,
        gather=args.eval_gather, spectra=entry.inputs == "dual", mesh=mesh)

    def prepare(cube, gt):
        if cube is not None and (cube.ndim != 3
                                 or cube.shape[2] != spec.num_bands):
            # refused here, on rank 0: the map would fail on every rank
            raise ValueError(f"cube of shape {cube.shape}, want (rows, "
                             f"cols, {spec.num_bands}) for {spec.name}")
        with span("serve.prep"):
            return prepare_scene(spec, root=args.data_root, cube=cube,
                                 gt=gt, patch_size=args.w, n_pc=args.n_PC,
                                 device=device, on_card=True)

    def classify(scene):
        """Rank 0's prepared scene (None on the others) on every rank, and
        its map."""
        if is_distributed(mesh):
            with span("serve.broadcast"):
                scene = broadcast_scene(scene, mesh)
        # the tile decomposition depends on scene.cols: a geometry change
        # rebuilds the predictor
        nonlocal predictor
        if predictor.cols != scene.cols:
            predictor = ScenePredictor(
                predictor.model, params=predictor.params, patch_size=args.w,
                cols=scene.cols, tile=args.val_batch_size,
                gather=args.eval_gather, spectra=predictor.spectra,
                mesh=mesh)
        with span("serve.map"):
            pred = predictor(scene)
            sync(device)
        return scene, pred

    def respond(obj):
        if primary:
            stdout.write(json.dumps(obj) + "\n")
            stdout.flush()

    def next_line(lines):
        """Rank 0: the next non-blank request line, or None at the end of
        stdin."""
        return next((line for line in map(str.strip, lines) if line), None)

    def take(line):
        """Rank 0: the header and job of request ``line``: ("map",
        (request, its start time, its prepared scene)), ("error", None)
        once it is answered, or ("stop", None) for None."""
        if line is None:
            return "stop", None
        req = None
        try:
            req = json.loads(line)
            t0 = time.perf_counter()
            if "cube" in req:
                with span("serve.read"):
                    cube = np.load(req["cube"])
                    gt = np.zeros(cube.shape[:2], np.int64)
            else:
                cube = gt = None  # registered .mat from --data_root
            return "map", (req, t0, prepare(cube, gt))
        except Exception as e:  # serve loop must survive bad requests
            respond(_error(req, e))
            return "error", None

    def answer(req, t0, scene, pred):
        with span("serve.write"):
            latency = time.perf_counter() - t0
            out = req.get("out")
            if out and out.endswith(".npy"):
                np.save(out, pred)
            elif out:
                save_class_map(out, pred + 1, spec, rows=scene.rows,
                               cols=scene.cols)
            respond({"id": req.get("id"), "pixels": int(pred.shape[0]),
                     "latency_s": latency, "out": out})

    if not args.no_warmup:
        t0 = time.perf_counter()
        scene = None
        if primary:
            cube = np.zeros((spec.rows, spec.cols, spec.num_bands))
            cube += np.random.default_rng(0).normal(
                1000.0, 100.0, cube.shape)  # PCA needs non-degenerate input
            gt = np.zeros((spec.rows, spec.cols), np.int64)
            # requests' cubes come as f32 (a .npy) or f64, and on the card
            # each dtype's prep has kernels of its own, loaded at first use
            prepare(cube.astype(np.float32), gt)
            scene = prepare(cube, gt)
        classify(scene)
        respond({"ready": True, "dataset": spec.name,
                 "warmup_s": time.perf_counter() - t0})
    else:
        respond({"ready": True, "dataset": spec.name})

    lines = iter(stdin) if primary else None
    while True:
        line = next_line(lines) if primary else None
        # rank 0's request span, from its line to its response
        with (span("serve.request") if line is not None
              else contextlib.nullcontext()):
            header, job = take(line) if primary else (None, None)
            header = broadcast_object(header, mesh)
            if header == "stop":
                break
            if header == "error":
                continue
            req, t0, scene = job if primary else (None, None, None)
            try:
                scene, pred = classify(scene)
            except Exception as e:
                if ranks:
                    raise  # a fault inside a rank's map ends the world
                respond(_error(req, e))
                continue
            if primary:
                try:
                    answer(req, t0, scene, pred)
                except Exception as e:  # the map is done on every rank
                    respond(_error(req, e))
    barrier(mesh)


if __name__ == "__main__":
    main()
