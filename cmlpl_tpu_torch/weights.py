"""Carrying weights and trainer states between the JAX package and the port.

The interchange format is the flax param tree in the JAX layout: conv
kernels (H, W, in, out), dense kernels (in, out), one ``bias`` per layer,
layers nested as the flax modules are (BaseNet2's ``conv1``, the CCT
tree's ``encoder/conv1`` and ``dec_base/fc``).  The torch ``state_dict``
key of a layer is its path joined by ``.`` (``encoder.conv1.weight``).  On
disk a tree is a flat ``.npz`` whose keys are the paths joined by ``/``
(for example ``"conv1/kernel"``), so a JAX user can write one from
``jax.device_get(params)`` with numpy alone, and the port reads it without
JAX.

A trainer state is carried in the same layout, the JAX package's state
tree: ``*_state_from_jax`` builds the port's state from a numpy copy of a
JAX state (or anything read the same way: fields by attribute, tuple
entries by index), and ``*_state_to_jax`` is its inverse, the nested dict
of numpy arrays that a checkpoint flattens (``utils/checkpoint.py``).  The
JAX state's PRNG key has no counterpart and is not carried.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from cmlpl_tpu_torch.models.basenet import FEAT_DIM, joint_dim


def state_dict_from_jax(params, prefix: str = "") -> dict[str, torch.Tensor]:
    """``state_dict`` of a flax param tree (nested mappings of arrays):
    every mapping that holds a ``kernel`` is a layer; 4-D kernels are convs
    (HWIO -> OIHW), 2-D ones dense ((in, out) -> (out, in))."""
    sd = {}
    for name, sub in params.items():
        path = prefix + name
        if "kernel" not in sub:
            sd.update(state_dict_from_jax(sub, path + "."))
            continue
        k = np.asarray(sub["kernel"], np.float32)
        k = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
        sd[f"{path}.weight"] = torch.from_numpy(np.ascontiguousarray(k))
        sd[f"{path}.bias"] = torch.from_numpy(
            np.asarray(sub["bias"], np.float32).copy())
    return sd


def params_to_jax(state_dict) -> dict:
    """The flax param tree (numpy f32) of a ``state_dict``: the inverse of
    :func:`state_dict_from_jax` (conv OIHW -> HWIO, dense (out, in) ->
    (in, out))."""
    params: dict = {}
    for key, w in state_dict.items():
        *path, leaf = key.split(".")
        if leaf != "weight":
            continue
        w = w.detach().cpu().numpy()
        node = params
        for name in path:
            node = node.setdefault(name, {})
        node["kernel"] = np.ascontiguousarray(
            w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T, np.float32)
        node["bias"] = (state_dict[".".join(path + ["bias"])].detach().cpu()
                        .numpy().astype(np.float32))
    return params


# the names the two had when they carried BaseNet2's tree only
basenet2_state_dict_from_jax = state_dict_from_jax
basenet2_params_to_jax = params_to_jax


def _carry_adam(opt: torch.optim.Adam, module: torch.nn.Module,
                adam) -> None:
    """One optax ``ScaleByAdamState`` into ``opt``'s state for the params of
    ``module`` that its moments name (``mu``/``nu``/``count`` -> torch
    ``exp_avg``/``exp_avg_sq``/``step``, under the params' transposes)."""
    step = torch.tensor(float(np.asarray(adam.count)))
    mu = state_dict_from_jax(adam.mu)
    nu = state_dict_from_jax(adam.nu)
    params = dict(module.named_parameters())
    for key, m in mu.items():
        p = params[key]
        opt.state[p] = {"step": step.clone(), "exp_avg": m.to(p.device),
                        "exp_avg_sq": nu[key].to(p.device)}


def _adam_to_jax(opt: torch.optim.Adam, module: torch.nn.Module) -> dict:
    """The optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) of
    ``opt``'s moments for the params of ``module`` that it steps: the
    inverse of :func:`_carry_adam`.  A param with no state yet (no step
    taken) has optax's initial zeros."""
    names = {p: n for n, p in module.named_parameters()}
    mu, nu, count = {}, {}, 0
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p)
            if st:
                mu[names[p]], nu[names[p]] = st["exp_avg"], st["exp_avg_sq"]
                count = int(st["step"])
            else:
                mu[names[p]] = nu[names[p]] = torch.zeros_like(p)
    return {"count": np.int32(count), "mu": params_to_jax(mu),
            "nu": params_to_jax(nu)}


def _net_to_jax(net) -> dict:
    """A ``NetState`` as the JAX package's: params and the optax state
    ``(ScaleByAdamState, EmptyState)``, whose second entry has no
    leaves."""
    return {"params": params_to_jax(net.model.state_dict()),
            "opt_state": {"0": _adam_to_jax(net.opt, net.model)}}


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _two_nets_from_jax(tree, state) -> None:
    """Both nets' Adam states and the step of a dual-BaseNet2 JAX state."""
    for jnet, net in ((tree.net_b, state.net_b), (tree.net_e, state.net_e)):
        _carry_adam(net.opt, net.model, jnet.opt_state[0])
    state.step = int(np.asarray(tree.step))


def cmlpl_state_from_jax(tree, trainer, run_seed: int = 0):
    """The port's CMLPL state from a numpy copy (``jax.device_get``) of the
    JAX package's ``CMLPLTrainState``, built by ``trainer``
    (:class:`cmlpl_tpu_torch.train.cmlpl.CMLPLTrainer`).

    Carries both nets' params and Adam states, both queues, the memory
    bank when the trainer keeps one (``extra_loss="memobank"``) and
    ``step``.  The JAX key has no torch counterpart: the generator is
    seeded with ``run_seed``."""
    state = trainer.new_state(tree.net_b.params, tree.net_e.params,
                              run_seed)
    _two_nets_from_jax(tree, state)
    for jq, q in ((tree.queue_w, state.queue_w),
                  (tree.queue_s, state.queue_s)):
        q.feats.copy_(torch.tensor(np.asarray(jq.feats, np.float32)))
        q.probs.copy_(torch.tensor(np.asarray(jq.probs, np.float32)))
        q.ptr = int(np.asarray(jq.ptr))
    if state.bank is not None:
        for name in ("feats", "count", "ptr"):
            getattr(state.bank, name).copy_(
                torch.from_numpy(np.asarray(getattr(tree.bank, name))))
    return state


def cmlpl_state_to_jax(state) -> dict:
    """The JAX package's ``CMLPLTrainState`` tree of a port CMLPL state,
    as nested dicts of numpy arrays, without the key: the inverse of
    :func:`cmlpl_state_from_jax`."""
    tree = {"net_b": _net_to_jax(state.net_b),
            "net_e": _net_to_jax(state.net_e)}
    for name in ("queue_w", "queue_s"):
        q = getattr(state, name)
        tree[name] = {"feats": _numpy(q.feats), "probs": _numpy(q.probs),
                      "ptr": np.int32(q.ptr)}
    tree["step"] = np.int32(state.step)
    if state.bank is not None:
        tree["bank"] = {name: _numpy(getattr(state.bank, name))
                        for name in ("feats", "count", "ptr")}
    return tree


def cps_state_from_jax(tree, trainer, run_seed: int = 0):
    """The port's CPS state from a numpy copy of the JAX package's
    ``CPSTrainState``, built by ``trainer``
    (:class:`cmlpl_tpu_torch.train.cps.CPSTrainer`): both nets' params and
    Adam states, and ``step``; the generator is seeded with ``run_seed``."""
    state = trainer.new_state(tree.net_b.params, tree.net_e.params,
                              run_seed)
    _two_nets_from_jax(tree, state)
    return state


def cps_state_to_jax(state) -> dict:
    """The JAX package's ``CPSTrainState`` tree of a port CPS state,
    without the key: the inverse of :func:`cps_state_from_jax`."""
    return {"net_b": _net_to_jax(state.net_b),
            "net_e": _net_to_jax(state.net_e), "step": np.int32(state.step)}


def cct_state_from_jax(tree, trainer, run_seed: int = 0):
    """The port's CCT state from a numpy copy of the JAX package's
    ``CCTTrainState``, built by ``trainer``
    (:class:`cmlpl_tpu_torch.train.cct.CCTTrainer`): the params tree, the
    two overlapping Adam states (``opt_base`` over encoder and
    ``dec_base``, ``opt_aug`` over encoder, ``dec1`` and ``dec2``; the
    encoder's params have moments in both) and ``step``; the generator is
    seeded with ``run_seed``."""
    state = trainer.new_state(tree.params, run_seed)
    _carry_adam(state.opt_base, state.model, tree.opt_base[0])
    _carry_adam(state.opt_aug, state.model, tree.opt_aug[0])
    state.step = int(np.asarray(tree.step))
    return state


def cct_state_to_jax(state) -> dict:
    """The JAX package's ``CCTTrainState`` tree of a port CCT state,
    without the key: the inverse of :func:`cct_state_from_jax`."""
    return {"params": params_to_jax(state.model.state_dict()),
            "opt_base": {"0": _adam_to_jax(state.opt_base, state.model)},
            "opt_aug": {"0": _adam_to_jax(state.opt_aug, state.model)},
            "step": np.int32(state.step)}


def _init_layers(rng, shapes: Mapping) -> dict:
    """Params of the layers in ``shapes`` (kernel shapes, nested as the
    tree), drawn in order with torch's default init bounds,
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases
    (``cmlpl_tpu/core/init.py``)."""
    params = {}
    for name, shape in shapes.items():
        if isinstance(shape, Mapping):
            params[name] = _init_layers(rng, shape)
            continue
        bound = 1.0 / np.sqrt(int(np.prod(shape[:-1])))
        params[name] = {
            "kernel": rng.uniform(-bound, bound, shape).astype(np.float32),
            "bias": rng.uniform(-bound, bound, shape[-1:]).astype(np.float32),
        }
    return params


def _stem_shapes(n_pc: int, num_features: int) -> dict:
    return {"conv0": (1, 1, n_pc, 64), "conv1": (3, 3, 64, 64),
            "conv2": (3, 3, 64, 64), "feat_spe": (num_features, FEAT_DIM)}


def init_basenet2_params(seed, *, n_pc: int, num_features: int,
                         num_classes: int, patch_size: int = 20) -> dict:
    """Random BaseNet2 params in the JAX layout with torch-default init
    bounds.  ``seed`` is anything ``numpy.random.default_rng`` takes."""
    shapes = dict(_stem_shapes(n_pc, num_features),
                  classifier=(joint_dim(patch_size), num_classes))
    return _init_layers(np.random.default_rng(seed), shapes)


def init_cct_params(seed, *, n_pc: int, num_features: int,
                    num_classes: int, patch_size: int = 20) -> dict:
    """Random CCT params in the JAX layout (the tree of
    ``cmlpl_tpu/train/cct.py``'s state: ``encoder`` without the decoder,
    and the heads ``dec_base``, ``dec1``, ``dec2``, each ``{"fc": ...}``),
    with torch-default init bounds."""
    head = {"fc": (joint_dim(patch_size), num_classes)}
    shapes = {"encoder": _stem_shapes(n_pc, num_features),
              "dec_base": head, "dec1": head, "dec2": head}
    return _init_layers(np.random.default_rng(seed), shapes)


def _flatten(tree: Mapping, prefix: str = ""):
    for name, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", np.asarray(v)


def save_params_npz(path: str, params) -> None:
    """Write a param tree as a flat npz keyed by ``/``-joined paths (JAX
    layout)."""
    np.savez(path, **dict(_flatten(params)))


def load_params_npz(path: str) -> dict:
    """Read a flat ``/``-keyed npz back into a nested param tree."""
    params: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *path_, leaf = key.split("/")
            node = params
            for name in path_:
                node = node.setdefault(name, {})
            node[leaf] = z[key]
    return params
