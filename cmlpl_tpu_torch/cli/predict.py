"""One-shot serving CLI: classify a whole scene with a trained BaseNet2
(or zoo model).

    python -m cmlpl_tpu_torch.cli.predict --dataID 1 \
        --checkpoint_dir ./ckpt --net b --out map.svg
    python -m cmlpl_tpu_torch.cli.predict --dataID 1 --weights w.npz
    python -m cmlpl_tpu_torch.cli.predict --dataID 1 --model dbda \
        --weights dbda.npz

Counterpart of ``cmlpl_tpu/cli/predict.py``: net ``--net`` of the latest
checkpoint of ``--checkpoint_dir`` (the port's ``state.npz``, written by
``cli.train`` or ``cli.train_cps``), or ``--weights`` (a JAX-layout npz,
see :mod:`cmlpl_tpu_torch.weights`).  ``--model`` maps with any model of
the comparison zoo from the ``--weights`` that ``train_backbone
--weights_out`` wrote, as ``serve`` does.

``--multihost`` under ``torchrun`` (one process a card) maps the scene in
one strip a rank, as the JAX CLI maps it over its local devices: rank 0
reads the weights and prepares the scene, both are broadcast
(``core/mesh.broadcast_scene``), each rank maps its strip of tiles (or,
dense, of scene rows) and the labels are gathered to every rank.  Every
rank prints its timing and accuracy lines and returns the whole map;
rank 0 alone writes ``--out``.  A fault on one rank ends the world.

    python -m torch.distributed.run --nproc_per_node 2 \
        -m cmlpl_tpu_torch.cli.predict --multihost --dataID 1 --weights w.npz
"""

from __future__ import annotations

import time

from cmlpl_tpu_torch.cli._common import (base_parser, build_model, logits_fn,
                                         report_accuracy, resolve_model,
                                         setup_runtime, sync)
from cmlpl_tpu_torch.core.mesh import (broadcast_scene, create_mesh,
                                       is_primary)
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.data.splits import generate_splits
from cmlpl_tpu_torch.device import resolve_device
from cmlpl_tpu_torch.eval.inference import ScenePredictor
from cmlpl_tpu_torch.eval.metrics import cal_accuracy
from cmlpl_tpu_torch.eval.visualize import save_class_map
from cmlpl_tpu_torch.registry import get_dataset


def main(argv=None):
    p = base_parser()
    p.add_argument("--out", type=str, default="classification_map.svg")
    args = p.parse_args(argv)
    setup_runtime(args)
    device = resolve_device(args.device)
    mesh = create_mesh(device) if args.multihost else None
    primary = mesh is None or is_primary(mesh)

    spec = get_dataset(args.dataID)
    entry = resolve_model(args, spec)
    scene = None
    if primary:
        scene = prepare_scene(spec, root=args.data_root, patch_size=args.w,
                              n_pc=args.n_PC, device=device)
    scene = broadcast_scene(scene, mesh)
    model = build_model(args, spec, device, mesh)
    predictor = ScenePredictor(
        logits_fn(model, args.model), params=model.state_dict(),
        patch_size=args.w, cols=scene.cols, tile=args.val_batch_size,
        gather=args.eval_gather, spectra=entry.inputs == "dual", mesh=mesh)
    t0 = time.perf_counter()
    pred = predictor(scene)
    sync(device)
    print(f"classified {scene.num_pixels} pixels in "
          f"{time.perf_counter() - t0:.3f}s")

    if primary:
        save_class_map(args.out, pred + 1, spec, rows=scene.rows,
                       cols=scene.cols)
        print(f"wrote {args.out}")

    # if ground truth exists, also report test-split accuracy
    if scene.labels.max() > 0:
        splits = generate_splits(scene.labels, num_label=args.num_label)
        acc = cal_accuracy(pred[splits.test],
                           scene.labels[splits.test] - 1)
        report_accuracy(f"net {args.net.upper()}" if args.checkpoint_dir
                        else "weights", acc)
    return pred


if __name__ == "__main__":
    main()
