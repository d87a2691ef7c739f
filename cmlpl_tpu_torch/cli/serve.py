"""Persistent serving loop: load a trained BaseNet2 ONCE, classify many
scenes.

    python -m cmlpl_tpu_torch.cli.serve --dataID 1 --checkpoint_dir ./ckpt
    python -m cmlpl_tpu_torch.cli.serve --dataID 1 --weights w.npz

Counterpart of ``cmlpl_tpu/cli/serve.py``: net ``--net`` (b or e) of the
latest checkpoint of ``--checkpoint_dir``, or ``--weights``.  Requests
stream in as JSON lines on stdin and results stream out as JSON lines on
stdout.

Request line:  {"cube": "scene.npy", "out": "map.svg", "id": "r1"}
  - ``cube``: path to a (rows, cols, bands) .npy raw cube, or omitted to
    use the registered dataset's .mat from --data_root.
  - ``out``: ``.svg`` renders the class map with the dataset palette;
    ``.npy`` saves the raw 0-based prediction vector.
Response line: {"id": "r1", "pixels": N, "latency_s": ..., "out": ...}
A request that fails gets {"id": ..., "error": "..."} and the loop goes on.

``latency_s`` runs from reading the request to the map on the host, after
a device synchronise.  A scene whose dims differ from the previous
request's rebuilds the predictor for the new geometry.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from cmlpl_tpu_torch.cli._common import (base_parser, build_model, logits_fn,
                                         sync)
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.device import resolve_device
from cmlpl_tpu_torch.eval.inference import ScenePredictor
from cmlpl_tpu_torch.eval.visualize import save_class_map
from cmlpl_tpu_torch.registry import get_dataset


def main(argv=None, stdin=None, stdout=None):
    p = base_parser()
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the startup pass on the registered scene "
                        "geometry")
    args = p.parse_args(argv)
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    device = resolve_device(args.device)

    spec = get_dataset(args.dataID)
    model = build_model(args, spec, device)
    predictor = ScenePredictor(
        logits_fn(model), params=model.state_dict(), patch_size=args.w,
        cols=spec.cols, tile=args.val_batch_size, gather=args.eval_gather)

    def classify(cube, gt):
        scene = prepare_scene(spec, root=args.data_root, cube=cube, gt=gt,
                              patch_size=args.w, n_pc=args.n_PC,
                              device=device)
        # the tile decomposition depends on scene.cols: a geometry change
        # rebuilds the predictor
        nonlocal predictor
        if predictor.cols != scene.cols:
            predictor = ScenePredictor(
                predictor.model, params=predictor.params, patch_size=args.w,
                cols=scene.cols, tile=args.val_batch_size,
                gather=args.eval_gather)
        pred = predictor(scene)
        sync(device)
        return scene, pred

    def respond(obj):
        stdout.write(json.dumps(obj) + "\n")
        stdout.flush()

    if not args.no_warmup:
        t0 = time.perf_counter()
        cube = np.zeros((spec.rows, spec.cols, spec.num_bands))
        cube += np.random.default_rng(0).normal(
            1000.0, 100.0, cube.shape)  # PCA needs non-degenerate input
        classify(cube, np.zeros((spec.rows, spec.cols), np.int64))
        respond({"ready": True, "dataset": spec.name,
                 "warmup_s": time.perf_counter() - t0})
    else:
        respond({"ready": True, "dataset": spec.name})

    for line in stdin:
        line = line.strip()
        if not line:
            continue
        req = None
        try:
            req = json.loads(line)
            t0 = time.perf_counter()
            if "cube" in req:
                cube = np.load(req["cube"])
                gt = np.zeros(cube.shape[:2], np.int64)
            else:
                cube = gt = None  # registered .mat from --data_root
            scene, pred = classify(cube, gt)
            latency = time.perf_counter() - t0
            out = req.get("out")
            if out and out.endswith(".npy"):
                np.save(out, pred)
            elif out:
                save_class_map(out, pred + 1, spec, rows=scene.rows,
                               cols=scene.cols)
            respond({"id": req.get("id"), "pixels": int(pred.shape[0]),
                     "latency_s": latency, "out": out})
        except Exception as e:  # serve loop must survive bad requests
            respond({"id": (req.get("id") if isinstance(req, dict)
                            else None), "error": f"{type(e).__name__}: {e}"})


if __name__ == "__main__":
    main()
