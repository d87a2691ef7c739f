"""Carrying weights and trainer states between the JAX package and the port.

The interchange format is the flax param tree in the JAX layout: conv
kernels (H, W, in, out) or (H, W, D, in, out), dense kernels (in, out),
norms' ``scale`` and ``bias``, free params (``gamma``, embeddings) by
name, layers nested as the flax modules are (BaseNet2's ``conv1``, the CCT
tree's ``encoder/conv1`` and ``dec_base/fc``, DBDA's ``trunk/conv11``); a
zoo model's BatchNorm statistics are the separate ``batch_stats`` tree
(``mean``/``var``), torch's ``running_mean``/``running_var``.  The torch
``state_dict`` key of a layer is its path joined by ``.``
(``encoder.conv1.weight``).  On
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

On a ("data", "model") mesh (``core/mesh.create_mesh_2d``) the trainer
builds each rank's shards: ``*_state_from_jax`` cuts them out of the
whole tree (``core/mesh.tp_shard_tree``: params, Adam's ``mu``/``nu``,
the EMA teacher, the queues' ``feats``), and ``*_state_to_jax`` gathers
them back into the whole tree on every rank (``tp_gather_tree``, a
collective of the model ranks), so a checkpoint written over the mesh is
the ``state.npz`` one process writes.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from cmlpl_tpu_torch.core.mesh import tp_gather_tree, tp_of, tp_shard_tree
from cmlpl_tpu_torch.models import common
from cmlpl_tpu_torch.models.basenet import FEAT_DIM, joint_dim


class StateTree(dict):
    """A nested dict of a JAX-layout state (``*_state_to_jax``, a
    ``state.npz`` read back, or one broadcast from another rank) read as
    ``*_state_from_jax`` reads a JAX state: fields by attribute, tuple
    entries by index."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __getitem__(self, key):
        value = super().__getitem__(str(key))
        return StateTree(value) if isinstance(value, dict) else value


#: torch weight dims -> the permutation to the flax kernel (conv HWIO /
#: DHWIO, dense (in, out)); its inverse below
_TO_FLAX = {2: (1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}
_FROM_FLAX = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def state_dict_from_jax(params, prefix: str = "",
                        batch_stats=None) -> dict[str, torch.Tensor]:
    """``state_dict`` of a flax param tree (nested mappings of arrays),
    with the running statistics of ``batch_stats`` (the tree of a model's
    BatchNorm ``mean``/``var``) when given.

    A ``kernel`` is a conv's (2-D HWIO -> OIHW, 3-D DHWIO -> OIDHW) or a
    dense layer's ((in, out) -> (out, in)) ``weight``; a norm's ``scale``
    is its ``weight``; every other leaf (``bias``, PReLU's
    ``negative_slope``, ``gamma``, embeddings) keeps its name."""
    sd = {}
    for name, sub in params.items():
        path = prefix + name
        if isinstance(sub, Mapping):
            stats = None if batch_stats is None else batch_stats.get(name)
            sd.update(state_dict_from_jax(sub, path + ".", stats))
            continue
        a = np.array(sub, np.float32)
        if name == "kernel":
            name = "weight"
            a = np.array(a.transpose(_FROM_FLAX[a.ndim]), order="C")
        elif name == "scale":
            name = "weight"
            if batch_stats is not None:
                for leaf in ("mean", "var"):
                    sd[f"{prefix}running_{leaf}"] = torch.from_numpy(
                        np.asarray(batch_stats[leaf], np.float32).copy())
        sd[prefix + name] = torch.from_numpy(a)
    return sd


def params_to_jax(state_dict) -> dict:
    """The flax param tree (numpy f32) of a ``state_dict``: the inverse of
    :func:`state_dict_from_jax` (a ``weight`` of 2, 4 or 5 dims is a
    kernel, of 1 dim a norm's ``scale``); the running statistics go to
    :func:`batch_stats_to_jax`."""
    params: dict = {}
    for key, w in state_dict.items():
        *path, leaf = key.split(".")
        if leaf in ("running_mean", "running_var", "num_batches_tracked"):
            continue
        w = w.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            leaf = "kernel" if w.ndim > 1 else "scale"
            if w.ndim > 1:
                w = w.transpose(_TO_FLAX[w.ndim])
        node = params
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = np.array(w, order="C")
    return params


def batch_stats_to_jax(state_dict) -> dict:
    """The flax ``batch_stats`` tree (``mean``/``var`` per BatchNorm) of a
    ``state_dict``'s running statistics; {} for a model without them."""
    stats: dict = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        if leaf not in ("running_mean", "running_var"):
            continue
        node = stats
        for name in path:
            node = node.setdefault(name, {})
        node[leaf[len("running_"):]] = t.detach().cpu().numpy().astype(
            np.float32)
    return stats


def zoo_state_dict_from_jax(name: str, variables) -> dict[str, torch.Tensor]:
    """``state_dict`` of zoo model ``name`` from its flax ``variables``
    (``{"params": ..., "batch_stats": ...}``, the latter absent or empty
    for a model without BatchNorm), running statistics included."""
    _zoo_entry(name)
    stats = variables.get("batch_stats") or None
    return state_dict_from_jax(variables["params"], batch_stats=stats)


def zoo_variables_to_jax(name: str, state_dict) -> dict:
    """The flax ``{"params", "batch_stats"}`` of a zoo model's
    ``state_dict``: the inverse of :func:`zoo_state_dict_from_jax`."""
    _zoo_entry(name)
    return {"params": params_to_jax(state_dict),
            "batch_stats": batch_stats_to_jax(state_dict)}


def _zoo_entry(name: str):
    from cmlpl_tpu_torch.models.zoo import ZOO

    if name.lower() not in ZOO:
        raise KeyError(f"unknown zoo model {name!r}; one of {sorted(ZOO)}")
    return ZOO[name.lower()]


# the names the two had when they carried BaseNet2's tree only
basenet2_state_dict_from_jax = state_dict_from_jax
basenet2_params_to_jax = params_to_jax


def _carry_adam(opt: torch.optim.Adam, module: torch.nn.Module,
                adam) -> None:
    """One optax ``ScaleByAdamState`` into ``opt``'s state for the params of
    ``module`` that its moments name (``mu``/``nu``/``count`` -> torch
    ``exp_avg``/``exp_avg_sq``/``step``, under the params' transposes),
    cut to the module's shards."""
    tp = tp_of(module)
    step = torch.tensor(float(np.asarray(adam.count)))
    mu = state_dict_from_jax(tp_shard_tree(adam.mu, tp))
    nu = state_dict_from_jax(tp_shard_tree(adam.nu, tp))
    params = dict(module.named_parameters())
    for key, m in mu.items():
        p = params[key]
        opt.state[p] = {"step": step.clone(), "exp_avg": m.to(p.device),
                        "exp_avg_sq": nu[key].to(p.device)}


def _adam_to_jax(opt: torch.optim.Adam, module: torch.nn.Module) -> dict:
    """The optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) of
    ``opt``'s moments for the params of ``module`` that it steps: the
    inverse of :func:`_carry_adam`.  A param with no state yet (no step
    taken) has optax's initial zeros.  A sharded module's moments are
    gathered whole."""
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
    tp = tp_of(module)
    return {"count": np.int32(count),
            "mu": tp_gather_tree(params_to_jax(mu), tp),
            "nu": tp_gather_tree(params_to_jax(nu), tp)}


def whole_params(module: torch.nn.Module) -> dict:
    """The flax param tree of ``module``, its shards gathered whole (a
    collective of the model ranks when it holds shards)."""
    return tp_gather_tree(params_to_jax(module.state_dict()), tp_of(module))


def _net_to_jax(net) -> dict:
    """A ``NetState`` as the JAX package's: params and the optax state
    ``(ScaleByAdamState, EmptyState)``, whose second entry has no
    leaves."""
    return {"params": whole_params(net.model),
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
    for name in ("queue_w", "queue_s"):
        jq, q = getattr(tree, name), getattr(state, name)
        feats = tp_shard_tree({name: {"feats": np.asarray(
            jq.feats, np.float32)}}, tp_of(state.net_b.model))[name]["feats"]
        q.feats.copy_(torch.tensor(feats))
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
        # split with the nets
        tree.update(tp_gather_tree({name: tree[name]},
                                   tp_of(state.net_b.model)))
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
    return {"params": whole_params(state.model),
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


# --------------------------------------------------------------------------
# the comparison zoo and the supervised trainer
# --------------------------------------------------------------------------

#: zoo models whose layers all take torch's default init (``tconv``/
#: ``tdense``, ``cmlpl_tpu/models/common.py``); the others take flax's
#: defaults but in the layers of :func:`_torch_init`
TORCH_INIT_MODELS = ("basenet1", "basenet2", "basenet2_zoo")


def _torch_init(name: str, path: tuple) -> bool:
    """Whether the layer at ``path`` of zoo model ``name`` is built by
    ``tconv``/``tdense``: every layer of the BaseNets, PAM's q/k/v convs
    (``attention.py:26-28``, DBDA's ``attention_spatial``) and SSFTT's
    transformer (``ssftt.py:30,44,59,62``)."""
    return (name in TORCH_INIT_MODELS or "attention_spatial" in path
            or (name == "ssftt" and path[:1] == ("transformer",)))

#: flax's init of the zoo's free-standing params, by name
#: (``cmlpl_tpu/models/{attention,ssftt,msvit}.py``)
_RAW_INITS = {"gamma": common.zeros, "token_wA": common.xavier_normal,
              "token_wV": common.xavier_normal, "cls_token": common.zeros,
              "pos_embedding": common.normal(0.02),
              "branch_weight": common.ones, "negative_slope":
              common.constant(0.01)}


def _zoo_variables(name: str, spec, n_pc: int, patch_size: int) -> dict:
    """``{"params", "batch_stats"}`` of a zoo model as built (torch's
    default values; only the tree and shapes are used), the global
    generator left as it was."""
    from cmlpl_tpu_torch.models.zoo import build_model

    with torch.random.fork_rng():
        model, _ = build_model(name, spec, n_pc, patch_size)
    return zoo_variables_to_jax(name, model.state_dict())


def init_zoo_params(name: str, seed, *, spec, n_pc: int,
                    patch_size: int) -> dict:
    """Random ``{"params", "batch_stats"}`` of zoo model ``name`` in the
    JAX layout, drawn from the distributions of the JAX model's own
    initialisers (``seed``: anything ``numpy.random.default_rng`` takes).

    The layers the JAX models build with ``tconv``/``tdense`` take torch's
    default bounds (:func:`_torch_init`).  The others take flax's defaults:
    LeCun-normal kernels (truncated), zero biases, unit norm scales, and
    the explicit draws of the JAX models: SSFTT's ``token_wA``/``token_wV``
    (Xavier normal), ``pos_embedding`` (normal 0.02) and head (Xavier
    uniform kernel, normal 1e-6 bias, ``ssftt.py:121-142``), MSViT's zero
    position embeddings and unit branch weights, CAM/PAM's zero ``gamma``,
    PReLU's 0.01.  Running statistics start at mean 0, var 1."""
    name = name.lower()
    rng = np.random.default_rng(seed)
    tree = _zoo_variables(name, spec, n_pc, patch_size)

    def draw(node: Mapping, path: tuple) -> dict:
        out = {}
        for leaf, value in node.items():
            if isinstance(value, Mapping):
                out[leaf] = draw(value, path + (leaf,))
                continue
            shape = value.shape
            layer = path[-1] if path else ""
            torch_init = _torch_init(name, path)
            if leaf == "kernel":
                init = (common.torch_uniform if torch_init
                        else common.xavier_uniform
                        if (name, path) == ("ssftt", ("head",))
                        else common.lecun_normal)
                out[leaf] = init(rng, shape)
            elif leaf == "bias" and "kernel" in node and torch_init:
                out[leaf] = common.torch_uniform(
                    rng, shape, int(np.prod(node["kernel"].shape[:-1])))
            elif leaf == "bias" and (name, layer) == ("ssftt", "head"):
                out[leaf] = common.normal(1e-6)(rng, shape)
            elif leaf in ("bias", "mean"):
                out[leaf] = common.zeros(rng, shape)
            elif leaf in ("scale", "var"):
                out[leaf] = common.ones(rng, shape)
            else:
                init = _RAW_INITS.get(leaf)
                if init is None and leaf.startswith("pos_embedding_"):
                    init = common.zeros          # MSViT's branches
                out[leaf] = init(rng, shape)
        return out

    return {"params": draw(tree["params"], ()),
            "batch_stats": draw(tree["batch_stats"], ())}


def supervised_state_to_jax(state) -> dict:
    """The JAX package's ``SupervisedState`` tree (``train/supervised.py:
    27-36``) of a port supervised state, without the key: params,
    batch_stats, the Adam state, step, and the EMA teacher's
    ``{"params", "batch_stats"}`` ({} without one)."""
    sd = state.model.state_dict()
    tree = {"params": whole_params(state.model),
            "batch_stats": batch_stats_to_jax(sd),
            "opt_state": {"0": _adam_to_jax(state.opt, state.model)},
            "step": np.int32(state.step), "ema": {}}
    if state.ema is not None:
        tree["ema"] = {"params": whole_params(state.ema),
                       "batch_stats": batch_stats_to_jax(
                           state.ema.state_dict())}
    return tree


def supervised_state_from_jax(tree, trainer, run_seed: int = 0):
    """The port's supervised state from a numpy copy of the JAX package's
    ``SupervisedState`` (or :func:`supervised_state_to_jax`'s tree), built
    by ``trainer`` (:class:`cmlpl_tpu_torch.train.supervised.
    SupervisedTrainer`): params, batch stats, the Adam state, step and,
    when the trainer keeps one, the EMA teacher; the generator is seeded
    with ``run_seed``."""
    state = trainer.new_state(tree.params,
                              getattr(tree, "batch_stats", None) or {},
                              run_seed)
    _carry_adam(state.opt, state.model, tree.opt_state[0])
    state.step = int(np.asarray(tree.step))
    ema = getattr(tree, "ema", None)
    if state.ema is not None and ema:
        sd = state_dict_from_jax(tp_shard_tree(ema["params"],
                                               tp_of(state.ema)),
                                 batch_stats=ema.get("batch_stats") or None)
        state.ema.load_state_dict({k: v.to(trainer.device)
                                   for k, v in sd.items()})
    return state
