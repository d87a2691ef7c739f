#!/usr/bin/env python3
"""OA bank of the JAX package's comparison-model zoo on the hard synthetic
scene: ``docs/zoo_jax_seeds.json``.

For each ``ZOO`` entry, the steps of ``cmlpl_tpu.cli.train_backbone`` at
the entry's default ``w`` and ``n_PC``: the oracle's A/B scene
(``scripts/reference_oracle.py:342-344,404-409``: ``synthetic_scene(0,
rows=64, cols=48, noise_std=1.2, class_sep=0.35)``, 9 classes, 103 bands)
and its splits (``generate_splits(gt, num_label=5)``: 45 labeled pixels),
``SupervisedTrainer`` with lr 5e-4 for 100 epochs of one batch of 45 (100
steps), then ``ScenePredictor`` in tiles of 512 and OA over the test
pixels.  Seed s keys the init and the dropout (``seed_everything(s)``), as
the CLI's ``--seed``; the batch order is ``fit``'s default, as in the
CLI.  ``chip_smoke.py`` (phase ``zoo_ab``) trains the
port's ``cli.train_backbone`` with the same flags on the card and holds
each model's mean OA against this bank.

The steps are those of the CLI, but the script dispatches one jitted step
at a time (``fit(scan_run=False)``) where the CLI scans the whole schedule
in one dispatch: on XLA:CPU the scanned 3-D convolutions of DBDA, SSRN
and FDSSC run about five times slower than the same steps dispatched one
by one (DBDA: 112 s for 10 epochs by the CLI), and the trained state is
the same either way.  The CLI also ignores ``--scene_npz``, so it cannot
read this scene.

    JAX_PLATFORMS=cpu python scripts/zoo_jax_seeds.py --seeds 6 --procs 3 \
        2> seeds.log

Runs on the CPU, one process per model (``--procs`` at a time), and
reports one JSON line per seed to stderr.  ``--assemble seeds.log ...``
writes the bank from such lines instead (runs split over several
invocations, or cut short), each model's seeds in order.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the heaviest on XLA:CPU first
MODELS = ("fdssc", "ssrn", "dbda", "dbda_feature", "msvit", "ssftt",
          "basenet1", "basenet2", "basenet2_zoo")
FIRST_SEED = 1088
NUM_LABEL, EPOCHS, BATCH, LR, TILE = 5, 100, 128, 5e-4, 512
#: the same run as flags of the port's cli.train_backbone
#: (with --scene_npz and --splits_dir of this scene)
CLI_FLAGS = ["--dataID", "0", "--num_label", str(NUM_LABEL),
             "--num_epochs", str(EPOCHS), "--labeled_batch_size", str(BATCH),
             "--val_batch_size", str(TILE), "--lr", str(LR),
             "--print_per_batches", "0"]
SCENE = dict(rows=64, cols=48, noise_std=1.2, class_sep=0.35)


def run_model(model: str, seeds: int) -> list[float]:
    """OA (percent) of ``model`` at each seed, in this process."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from cmlpl_tpu.core.rng import seed_everything
    from cmlpl_tpu.data import (generate_splits, prepare_scene,
                                synthetic_scene)
    from cmlpl_tpu.eval import ScenePredictor, cal_accuracy
    from cmlpl_tpu.models.zoo import ZOO, build_model
    from cmlpl_tpu.registry import get_dataset
    from cmlpl_tpu.train.supervised import SupervisedTrainer

    spec = get_dataset(0)
    entry = ZOO[model]
    w = entry.default_patch
    n_pc = spec.num_bands if entry.default_n_pc == -1 else entry.default_n_pc
    cube, gt = synthetic_scene(0, **SCENE)
    scene = prepare_scene(0, cube=cube, gt=gt, patch_size=w, n_pc=n_pc)
    splits = generate_splits(scene.labels, num_label=NUM_LABEL)
    y_test = scene.labels[splits.test] - 1
    oas = []
    for s in range(seeds):
        seed = FIRST_SEED + s
        rng = seed_everything(seed)
        net, entry = build_model(model, spec, n_pc)
        trainer = SupervisedTrainer(net, entry, lr=LR, patch_size=w,
                                    n_pc=n_pc, num_features=spec.num_bands,
                                    donate=False)
        state = trainer.init_state(rng)
        state, _ = trainer.fit(
            state, scene, splits.train, scene.labels,
            batch_size=min(BATCH, len(splits.train)), num_epochs=EPOCHS,
            log_every=0, scan_run=False)
        predictor = ScenePredictor(trainer.logits_fn(), patch_size=w,
                                   cols=scene.cols, tile=TILE)
        pred = predictor(trainer.eval_variables(state), scene)
        oas.append(float(cal_accuracy(pred[splits.test], y_test).oa) * 100)
        print(json.dumps({"model": model, "seed": seed, "oa": oas[-1]}),
              file=sys.stderr, flush=True)
    return oas


def run_all(args) -> dict:
    """{model: [OA per seed]} of ``args.models``, ``args.procs`` model
    processes at a time."""
    import time

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in [ROOT, os.environ.get("PYTHONPATH")] if p))
    pending, running, bank = list(args.models), {}, {}
    while pending or running:
        while pending and len(running) < args.procs:
            model = pending.pop(0)
            running[model] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--one", model,
                 "--seeds", str(args.seeds)], env=env,
                stdout=subprocess.PIPE, text=True)
        done = [m for m, proc in running.items() if proc.poll() is not None]
        if not done:
            time.sleep(5)
        for model in done:
            proc = running.pop(model)
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"{model}: exit {proc.returncode}")
            bank[model] = json.loads(out.strip().splitlines()[-1])
    return bank


def assemble(logs) -> dict:
    """{model: [OA per seed]} from the seed lines of ``logs``."""
    seeds: dict = {}
    for path in logs:
        with open(path) as f:
            for line in f:
                if line.startswith('{"model"'):
                    d = json.loads(line)
                    seeds.setdefault(d["model"], {})[d["seed"]] = d["oa"]
    return {m: [by_seed[s] for s in sorted(by_seed)]
            for m, by_seed in seeds.items()}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, default=6)
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--models", nargs="*", default=list(MODELS))
    p.add_argument("--out", default=os.path.join(ROOT, "docs",
                                                 "zoo_jax_seeds.json"))
    p.add_argument("--assemble", nargs="+", default=None,
                   help="write the bank from these logs' seed lines")
    p.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.one:
        print(json.dumps(run_model(args.one, args.seeds)))
        return 0

    bank = assemble(args.assemble) if args.assemble else run_all(args)

    import numpy as np

    doc = {"what": "OA (percent) of the JAX package's cli.train_backbone "
                   "steps on the hard synthetic scene, per ZOO model, one "
                   f"per seed from {FIRST_SEED} on",
           "script": "scripts/zoo_jax_seeds.py", "scene": SCENE,
           "port_cli_flags": CLI_FLAGS, "first_seed": FIRST_SEED,
           "device": "cpu (JAX_PLATFORMS=cpu)", "models": {}}
    for model in MODELS:
        if model in bank:
            oa = np.array(bank[model])
            doc["models"][model] = {"oa": bank[model],
                                    "mean": float(oa.mean()),
                                    "sd": float(oa.std(ddof=1))}
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
