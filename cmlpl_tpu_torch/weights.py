"""Carrying BaseNet2 weights between the JAX package and the port.

The interchange format is the flax param tree in the JAX layout: conv
kernels (H, W, in, out), dense kernels (in, out), one ``bias`` per layer.
On disk it is a flat ``.npz`` whose keys are ``"<layer>/<leaf>"`` (for
example ``"conv1/kernel"``), so a JAX user can write one from
``jax.device_get(params)`` with numpy alone, and the port reads it without
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

CONV_LAYERS = ("conv0", "conv1", "conv2")
DENSE_LAYERS = ("feat_spe", "classifier")


def basenet2_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """BaseNet2 ``state_dict`` from the flax param tree (nested dicts of
    arrays): conv HWIO -> OIHW, dense (in, out) -> (out, in)."""
    sd = {}
    for name in CONV_LAYERS + DENSE_LAYERS:
        k = np.asarray(params[name]["kernel"], np.float32)
        k = k.transpose(3, 2, 0, 1) if name in CONV_LAYERS else k.T
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(k))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.asarray(params[name]["bias"], np.float32).copy())
    return sd


def basenet2_params_to_jax(state_dict) -> dict:
    """The flax param tree (numpy f32) of a BaseNet2 ``state_dict``: the
    inverse of :func:`basenet2_state_dict_from_jax` (conv OIHW -> HWIO,
    dense (out, in) -> (in, out))."""
    params = {}
    for name in CONV_LAYERS + DENSE_LAYERS:
        w = state_dict[f"{name}.weight"].detach().cpu().numpy()
        k = w.transpose(2, 3, 1, 0) if name in CONV_LAYERS else w.T
        params[name] = {
            "kernel": np.ascontiguousarray(k, np.float32),
            "bias": state_dict[f"{name}.bias"].detach().cpu().numpy()
            .astype(np.float32)}
    return params


def cmlpl_state_from_jax(tree, trainer, run_seed: int = 0):
    """The port's CMLPL state from a numpy copy (``jax.device_get``) of the
    JAX package's ``CMLPLTrainState``, built by ``trainer``
    (:class:`cmlpl_tpu_torch.train.cmlpl.CMLPLTrainer`).

    Carries both nets' params; their Adam states (optax ``mu``/``nu``/
    ``count`` -> torch ``exp_avg``/``exp_avg_sq``/``step``, under the
    params' transposes); both queues and ``step``.  The JAX key has no
    torch counterpart: the generator is seeded with ``run_seed``."""
    state = trainer.new_state(tree.net_b.params, tree.net_e.params,
                              run_seed)
    for jnet, net in ((tree.net_b, state.net_b), (tree.net_e, state.net_e)):
        adam = jnet.opt_state[0]     # (ScaleByAdamState, EmptyState)
        step = torch.tensor(float(np.asarray(adam.count)))
        mu = basenet2_state_dict_from_jax(adam.mu)
        nu = basenet2_state_dict_from_jax(adam.nu)
        for key, p in net.model.named_parameters():
            net.opt.state[p] = {"step": step.clone(),
                                "exp_avg": mu[key].to(p.device),
                                "exp_avg_sq": nu[key].to(p.device)}
    for jq, q in ((tree.queue_w, state.queue_w),
                  (tree.queue_s, state.queue_s)):
        q.feats.copy_(torch.tensor(np.asarray(jq.feats, np.float32)))
        q.probs.copy_(torch.tensor(np.asarray(jq.probs, np.float32)))
        q.ptr = int(np.asarray(jq.ptr))
    state.step = int(np.asarray(tree.step))
    return state


def init_basenet2_params(seed, *, n_pc: int, num_features: int,
                         num_classes: int, patch_size: int = 20) -> dict:
    """Random BaseNet2 params in the JAX layout, drawn from numpy with
    torch's default init bounds, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
    weights and biases (``cmlpl_tpu/core/init.py``).  ``seed`` is anything
    ``numpy.random.default_rng`` takes."""
    rng = np.random.default_rng(seed)
    spatial = 64 * (patch_size // 4) ** 2
    shapes = {"conv0": (1, 1, n_pc, 64), "conv1": (3, 3, 64, 64),
              "conv2": (3, 3, 64, 64), "feat_spe": (num_features, 1024),
              "classifier": (spatial + 1024, num_classes)}
    params = {}
    for name, shape in shapes.items():
        bound = 1.0 / np.sqrt(int(np.prod(shape[:-1])))
        params[name] = {
            "kernel": rng.uniform(-bound, bound, shape).astype(np.float32),
            "bias": rng.uniform(-bound, bound, shape[-1:]).astype(np.float32),
        }
    return params


def save_params_npz(path: str, params) -> None:
    """Write a param tree as a flat ``"<layer>/<leaf>"`` npz (JAX layout)."""
    flat = {f"{layer}/{leaf}": np.asarray(v)
            for layer, leaves in params.items()
            for leaf, v in leaves.items()}
    np.savez(path, **flat)


def load_params_npz(path: str) -> dict:
    """Read a flat ``"<layer>/<leaf>"`` npz back into a nested param tree."""
    params: dict = {}
    with np.load(path) as z:
        for key in z.files:
            layer, leaf = key.split("/")
            params.setdefault(layer, {})[leaf] = z[key]
    return params
