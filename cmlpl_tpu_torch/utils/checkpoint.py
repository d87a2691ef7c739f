"""Checkpoints and resume (``cmlpl_tpu/utils/checkpoint.py``).

The directory contract is the JAX package's: ``<directory>/<step>/``, and
a restore without a step takes the largest numeric one.  The format is the
port's own, since orbax needs JAX: ``state.npz``, the trainer state as one
flat ``/``-keyed npz in the JAX package's state layout
(``net_b/params/conv1/kernel``, ``net_b/opt_state/0/mu/...``,
``queue_w/feats``, ``bank/...``, ``step``; see ``weights.py``), and
``generator.npy``, the bytes of the state's ``torch.Generator``
(``get_state()``), the port's own leaf where the JAX state holds a key.

A JAX user writes ``state.npz`` from ``jax.device_get(state)`` with numpy
alone; a checkpoint without ``generator.npy`` restores with the generator
seeded as ``*_state_from_jax`` seeds it.  A generator state restores only
on the device type that saved it (the CPU's Mersenne Twister and CUDA's
Philox keep different states).

Over a mesh every rank calls :func:`save_checkpoint`: a state sharded
over a ("data", "model") mesh is gathered whole first (a collective of
the model ranks), and rank 0 writes the ``state.npz`` that one process
writes.  :func:`restore_checkpoint` builds, on each rank that calls it,
the rank's shards of the whole tree; ``cli/_common.maybe_resume`` reads
the files on rank 0 alone and broadcasts them.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from cmlpl_tpu_torch.core.mesh import is_primary
from cmlpl_tpu_torch.weights import (StateTree, load_params_npz,
                                     save_params_npz)

STATE_FILE = "state.npz"
GENERATOR_FILE = "generator.npy"


def save_checkpoint(directory: str, trainer, state,
                    step: int | None = None, generator: bool = True) -> str:
    """Write ``state`` (of ``trainer``, which gives its JAX-layout tree)
    under ``<directory>/<step>/``, the state's step by default, replacing
    one there; returns its path.  The files are written to a sibling
    directory first and moved into place, so a run cut during a save
    leaves the last whole checkpoint the latest.  ``generator=False``
    writes no ``generator.npy`` (a state whose draws came from elsewhere:
    an exported run's, ``cli/export_model.py --import_run``).  Over the
    trainer's mesh rank 0 alone writes; every rank takes the state's
    whole tree (module docstring)."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, str(state.step if step is None else step))
    tree = trainer.state_to_jax(state)
    if not is_primary(getattr(trainer, "mesh", None)):
        return path
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    save_params_npz(os.path.join(tmp, STATE_FILE), tree)
    if generator:
        np.save(os.path.join(tmp, GENERATOR_FILE),
                state.generator.get_state().numpy())
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def checkpoint_path(directory: str, step: int | None = None) -> str:
    """``<directory>/<step>/``, the largest numeric step by default;
    FileNotFoundError when there is none."""
    directory = os.path.abspath(directory)
    if step is None:
        steps = ([int(d) for d in os.listdir(directory) if d.isdigit()]
                 if os.path.isdir(directory) else [])
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        step = max(steps)
    return os.path.join(directory, str(step))


def read_checkpoint(directory: str, step: int | None = None) -> tuple:
    """(the JAX-layout state tree, the generator's state or None) saved
    under ``<directory>/<step>/``, the largest numeric step by default;
    FileNotFoundError when there is none."""
    path = checkpoint_path(directory, step)
    tree = load_params_npz(os.path.join(path, STATE_FILE))
    gen = os.path.join(path, GENERATOR_FILE)
    return tree, np.load(gen) if os.path.exists(gen) else None


def state_from_checkpoint(trainer, tree, generator=None):
    """The state of ``trainer`` from :func:`read_checkpoint`'s pair: on a
    2-D mesh the rank's shards of it."""
    state = trainer.state_from_jax(StateTree(tree))
    if generator is not None:
        state.generator.set_state(torch.from_numpy(generator))
    return state


def restore_checkpoint(directory: str, trainer, step: int | None = None):
    """The state of ``trainer`` saved under ``<directory>/<step>/``, the
    largest numeric step by default; FileNotFoundError when there is
    none."""
    return state_from_checkpoint(trainer, *read_checkpoint(directory, step))


def load_net_params(directory: str, net: str, step: int | None = None):
    """One net's params (``"b"`` or ``"e"``) from the latest checkpoint of
    a two-net trainer (CMLPL, CPS) under ``directory``: the
    ``net_<net>/params`` subtree of its ``state.npz``, the flax tree that
    ``state_dict_from_jax`` reads.  Nothing else of the state is built:
    a map needs neither the Adam moments nor the generator."""
    path = checkpoint_path(directory, step)
    tree = load_params_npz(os.path.join(path, STATE_FILE))
    key = f"net_{net}"
    if key not in tree:
        raise KeyError(f"{path} holds no {key}: not a checkpoint of a "
                       f"two-net trainer (its keys: {sorted(tree)})")
    return tree[key]["params"]
