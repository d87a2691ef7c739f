"""Data preparation CLI (``cmlpl_tpu/cli/sample_generation.py``; reference
``sample_generation.py``).

    python -m cmlpl_tpu_torch.cli.sample_generation --dataID 1

Writes the split arrays (byte-identical to the reference seeds) plus the
z-scored spectra and labels under ``<data_root>/<dataset name>/``: what
the training CLIs' ``--splits_dir`` reads.  Host-only, as in the JAX
package: nothing here runs on a device, so it takes no ``--device``.
``--materialize_patches`` also writes the reference's NCHW patch tensor
``XP.npy`` (rows·cols, n_PC, w, w) f32, about 19.9 GB for PaviaU, chunk
by chunk into a memory-mapped file (``data/patches.extract_patches``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from cmlpl_tpu_torch.data.io import load_scene
from cmlpl_tpu_torch.data.patches import (chunk_rows, extract_patches,
                                          pad_symmetric, patch_pad_width)
from cmlpl_tpu_torch.data.prep import feature_normalize, pca_norm
from cmlpl_tpu_torch.data.splits import generate_splits
from cmlpl_tpu_torch.registry import get_dataset


def main(args=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataID", type=str, default="1")
    p.add_argument("--num_label", type=int, default=5)
    p.add_argument("--w", type=int, default=20)
    p.add_argument("--n_PC", type=int, default=60)
    p.add_argument("--data_root", type=str, default="./dataset")
    p.add_argument("--scene_npz", type=str, default=None,
                   help="load the raw scene from this .npz ('cube'/'gt' "
                        "arrays) instead of the registry .mat files")
    p.add_argument("--materialize_patches", action="store_true",
                   help="also write the reference's XP.npy patch tensor")
    args = p.parse_args(args)

    spec = get_dataset(args.dataID)
    if args.scene_npz:
        with np.load(args.scene_npz) as z:
            cube, gt = z["cube"], z["gt"]
    else:
        cube, gt = load_scene(spec, args.data_root)
    rows, cols, bands = cube.shape
    flat = cube.reshape(rows * cols, bands)

    x_pca = feature_normalize(pca_norm(flat, args.n_PC), 1)
    X = feature_normalize(flat, 1).astype(np.float32)
    Y = np.asarray(gt).reshape(-1)

    out = os.path.join(args.data_root, spec.name)
    os.makedirs(out, exist_ok=True)

    splits = generate_splits(Y, num_label=args.num_label)
    np.save(os.path.join(out, "X.npy"), X)
    np.save(os.path.join(out, "Y.npy"), Y)
    np.save(os.path.join(out, "train_array.npy"), splits.train)
    np.save(os.path.join(out, "test_array.npy"), splits.test)
    np.save(os.path.join(out, "unlabel_array.npy"), splits.unlabeled)

    if args.materialize_patches:
        padded = pad_symmetric(
            x_pca.reshape(rows, cols, args.n_PC).astype(np.float32),
            patch_pad_width(args.w))
        path = os.path.join(out, "XP.npy")
        shape = (rows * cols, args.n_PC, args.w, args.w)
        xp = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                       shape=shape)
        extract_patches(padded, rows, cols, args.w, out=xp)
        xp.flush()
        del xp
        chunks = -(-rows // chunk_rows(cols, args.n_PC, args.w))
        print(f"wrote {path} {shape} in {chunks} chunks")

    print(f"wrote splits for {spec.name} to {out}: "
          f"train={splits.train.shape[0]} test={splits.test.shape[0]} "
          f"unlabeled={splits.unlabeled.shape[0]}")


if __name__ == "__main__":
    main()
