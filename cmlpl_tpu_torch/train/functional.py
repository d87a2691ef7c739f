"""One training step as a pure function of the state's tensors, the
counterpart of the JAX package's functional step
(``cmlpl_tpu/train/cmlpl.py:229-425``), for the exported training run
(``utils/export.build_run_exported``).

The eager trainers step in place: ``loss.backward()``, two
``torch.optim.Adam`` and queue writes at a host pointer.  Here the same
step takes and returns tensors:

- the draws come from a :class:`~cmlpl_tpu_torch.core.rng.CounterStream`
  of ``state.rng`` and ``state.step`` through the trainer's own
  ``_draws``;
- the gradient is ``torch.func.grad_and_value`` of the trainer's own
  ``_losses`` through ``driver.Apply`` on the params;
- Adam is :func:`adam_update`, optax's state (``count``, ``mu``, ``nu``)
  stepped by ``torch.optim.Adam``'s single-tensor arithmetic, so on the
  CPU a step equals the eager one bit for bit;
- the queues are written out of place (``objectives/queue.queue_write``),
  and CMLPL's memory bank is the new bank ``_losses`` returns;
- the schedule (epoch, batch index, CMLPL's adaptive threshold) comes in
  as 0-d tensors, and the trainers turn its Python branches into selects.

:class:`StateLayout` names the state's tensors as the JAX bundle does
(``cmlpl_tpu/utils/export.py:_keypath_name`` of the JAX state tree) and
moves them between the flax layout of the bundle's inputs and the torch
layout of the step.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch
from torch.func import grad_and_value

from cmlpl_tpu_torch.core.rng import CounterStream
from cmlpl_tpu_torch.objectives.contrastive import MemoBankState
from cmlpl_tpu_torch.objectives.queue import QueueState, queue_write
from cmlpl_tpu_torch.train.driver import Apply
from cmlpl_tpu_torch.weights import _FROM_FLAX


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One tensor of the state: its bundle name, what it is, and where the
    step keeps it.  ``kind``: "param", "mu", "nu", "count", "queue",
    "bank", "rng" or "step"; ``key``: a param's full torch name
    (``"net_b.conv0.weight"``) or a queue's or the bank's
    ``"<name>.<field>"``;
    ``opt``: the index of the Adam of "mu", "nu" and "count";
    ``perm``: a kernel's flax -> torch permutation."""
    name: str
    kind: str
    key: str = ""
    opt: int = -1
    perm: tuple | None = None


#: the JAX state's dict-valued fields: flax param trees and optax's moment
#: trees, which JAX flattens in sorted key order
_DICT_FIELDS = ("params", "mu", "nu")


def _ordered(tree: Mapping, is_dict: bool = False):
    """(path, leaf) pairs in the JAX state tree's flatten order.  The
    port's ``*_state_to_jax`` trees hold the state's NamedTuple fields in
    their order (``params`` before ``opt_state``); below a dict field
    (:data:`_DICT_FIELDS`) keys are sorted, as JAX flattens a dict."""
    for k in (sorted(tree) if is_dict else list(tree)):
        sub = tree[k]
        if isinstance(sub, Mapping):
            for path, leaf in _ordered(sub, is_dict or k in _DICT_FIELDS):
                yield (k,) + path, leaf
        else:
            yield (k,), sub


def _torch_name(path) -> tuple[str, bool]:
    """A flax param path's torch name, and whether it is a kernel (whose
    permutation the caller takes from its rank)."""
    *mods, leaf = path
    if leaf in ("kernel", "scale"):
        leaf = "weight"
    return ".".join(list(mods) + [leaf]), path[-1] == "kernel"


class StateLayout:
    """The trainer state's tensors in the JAX bundle's order: their names,
    flax-layout values (``values``, numpy), and the moves between that
    layout and the step's.

    ``rng``: the run's key, uint32 (2,), placed just before ``state.step``
    as in the JAX state (CMLPL's bank follows the step there)."""

    def __init__(self, trainer, state, rng: np.ndarray):
        tree = {}
        for k, v in trainer.state_to_jax(state).items():
            if k == "step":
                tree["rng"] = np.asarray(rng, np.uint32)
            tree[k] = v
        params = trainer.JAX_PARAMS
        opts = trainer.JAX_OPTS
        carry = {k: "queue" if isinstance(c, QueueState) else "bank"
                 for k, c in trainer._carry(state).items()}
        self.leaves: list[Leaf] = []
        self.values: list[np.ndarray] = []
        for path, value in _ordered(tree):
            value = np.asarray(value)
            self.leaves.append(self._leaf(path, value, params, opts, carry))
            self.values.append(value)
        self.opt_keys = [[lf.key for lf in self.leaves
                          if lf.kind == "mu" and lf.opt == k]
                         for k in range(len(opts))]

    @staticmethod
    def _leaf(path, value, params, opts, carry) -> Leaf:
        name = "state." + ".".join(path)

        def param_leaf(kind, module, rest, opt=-1):
            key, is_kernel = _torch_name(rest)
            perm = _FROM_FLAX[value.ndim] if is_kernel else None
            return Leaf(name, kind, f"{module}.{key}", opt, perm)

        for module, prefix in params.items():
            if path[:len(prefix)] == prefix:
                return param_leaf("param", module, path[len(prefix):])
        for k, (module, prefix) in enumerate(opts):
            if path[:len(prefix)] == prefix:
                rest = path[len(prefix):]
                if rest == ("count",):
                    return Leaf(name, "count", opt=k)
                if rest[0] in ("mu", "nu"):
                    return param_leaf(rest[0], module, rest[1:], k)
        if path[0] in carry and len(path) == 2:
            return Leaf(name, carry[path[0]], ".".join(path))
        if path in (("rng",), ("step",)):
            return Leaf(name, path[0])
        raise ValueError(f"{name}: no place in a run program's state")

    @property
    def names(self) -> list[str]:
        return [lf.name for lf in self.leaves]

    def to_torch(self, tensors) -> list[torch.Tensor]:
        """Flax-layout tensors (the bundle's order) -> the step's layout:
        kernels permuted to torch's and made contiguous."""
        return [t.permute(lf.perm).contiguous() if lf.perm else t
                for lf, t in zip(self.leaves, tensors)]

    def to_jax(self, tensors) -> list[torch.Tensor]:
        """The inverse of :meth:`to_torch`."""
        out = []
        for lf, t in zip(self.leaves, tensors):
            if lf.perm:
                t = t.permute(tuple(np.argsort(lf.perm))).contiguous()
            out.append(t)
        return out

    def unpack(self, tensors) -> dict:
        """Step-layout tensors -> ``{"params": {key: t}, "opts": [{"count",
        "mu": {key: t}, "nu": {key: t}}], "carry": {queue: QueueState,
        "bank": MemoBankState}, "rng", "step"}``."""
        st = {"params": {}, "opts": [{"mu": {}, "nu": {}}
                                     for _ in self.opt_keys],
              "carry": {}}
        carried: dict = {}
        for lf, t in zip(self.leaves, tensors):
            if lf.kind == "param":
                st["params"][lf.key] = t
            elif lf.kind in ("mu", "nu"):
                st["opts"][lf.opt][lf.kind][lf.key] = t
            elif lf.kind == "count":
                st["opts"][lf.opt]["count"] = t
            elif lf.kind in ("queue", "bank"):
                name, field = lf.key.split(".")
                carried.setdefault(name, (lf.kind, {}))[1][field] = t
            else:
                st[lf.kind] = t
        st["carry"] = {name: (QueueState if kind == "queue"
                              else MemoBankState)(**fields)
                       for name, (kind, fields) in carried.items()}
        return st

    def pack(self, st: dict) -> list[torch.Tensor]:
        """The inverse of :meth:`unpack`, in the bundle's order."""
        out = []
        for lf in self.leaves:
            if lf.kind == "param":
                out.append(st["params"][lf.key])
            elif lf.kind in ("mu", "nu"):
                out.append(st["opts"][lf.opt][lf.kind][lf.key])
            elif lf.kind == "count":
                out.append(st["opts"][lf.opt]["count"])
            elif lf.kind in ("queue", "bank"):
                name, field = lf.key.split(".")
                out.append(getattr(st["carry"][name], field))
            else:
                out.append(st[lf.kind])
        return out


def adam_update(params: dict, grads: dict, opt: dict, keys, hyper: dict):
    """One step of the Adam ``opt`` (optax's ``count``/``mu``/``nu``) over
    the params named ``keys``, by ``torch.optim.Adam``'s single-tensor
    order of operations: ``lerp`` of the first moment, ``mul`` and
    ``addcmul`` of the second, ``param + (-step_size * m) / (sqrt(v) /
    sqrt(bc2) + eps)``.  The bias corrections are float64, as the
    optimizer computes them on the host, and ``bc2 ** 0.5`` is a ``pow``
    (not a ``sqrt``, which rounds otherwise at some steps).  Returns (the
    new params, the new optax state)."""
    lr, (beta1, beta2), eps = hyper["lr"], hyper["betas"], hyper["eps"]
    count = opt["count"] + 1
    t = count.to(torch.float64)
    bc1 = 1 - torch.pow(beta1, t)
    bc2 = 1 - torch.pow(beta2, t)
    neg_step = (-(torch.full_like(bc1, lr) / bc1)).to(torch.float32)
    bc2_sqrt = torch.pow(bc2, torch.full_like(bc2, 0.5)).to(torch.float32)
    params = dict(params)
    mu, nu = dict(opt["mu"]), dict(opt["nu"])
    for key in keys:
        g = grads[key]
        mu[key] = torch.lerp(mu[key], g, 1 - beta1)
        nu[key] = torch.addcmul(nu[key] * beta2, g, g, value=1 - beta2)
        denom = nu[key].sqrt() / bc2_sqrt + eps
        params[key] = params[key] + neg_step * mu[key] / denom
    return params, {"count": count, "mu": mu, "nu": nu}


def adam_hyper(opt: torch.optim.Adam) -> dict:
    """An eager Adam's hyperparameters, refusing what
    :func:`adam_update` does not replay."""
    d = opt.defaults
    if d.get("weight_decay") or d.get("amsgrad") or d.get("maximize"):
        raise ValueError("a run program replays plain Adam only")
    return {"lr": float(d["lr"]), "betas": tuple(map(float, d["betas"])),
            "eps": float(d["eps"])}


class RunStep:
    """``trainer``'s step as a pure function of a :class:`StateLayout`'s
    tensors (step layout).  ``state``: an eager state of the trainer,
    whose modules give the architecture and whose Adams the
    hyperparameters; its own tensors are not read.  ``cols``: the scene's
    columns, which a per-step gather (``gather_impl`` "xla", "pallas" or
    "pallas_bf16") needs."""

    def __init__(self, trainer, state, layout: StateLayout,
                 cols: int | None = None):
        self.trainer = trainer
        self.layout = layout
        self.modules = torch.nn.ModuleDict(trainer._modules(state))
        self.hyper = [adam_hyper(o) for o in trainer._opts(state)]
        self.per_step = trainer.config.gather_impl != "pool"
        if self.per_step and cols is None:
            raise ValueError("a per-step gather needs the scene's cols")
        self.cols = cols

    def __call__(self, tensors, xp_src, x_src, li, ly, ui, epoch,
                 batch_index, thr=None):
        """One step on the sources: in pool mode the pooled patches and
        spectra, ``li``/``ui`` rows of them; in a per-step mode the
        prepared cube (``make_train_gather``'s ``prep_cube``) and the
        spectra in the input dtype, ``li``/``ui`` pixel ids, whose patches
        the mode's gather takes (the plain gather, or a kernel's
        ``cmlpl::gather_patches_*`` operator, one node of a traced step)
        and casts as the eager step does.  ``ly`` the labels;
        ``epoch``/``batch_index`` 0-d integer tensors and ``thr`` CMLPL's
        adaptive threshold (0-d f32).  Returns (the new tensors, the
        step's metrics as 0-d tensors)."""
        tr = self.trainer
        st = self.layout.unpack(tensors)
        ly = ly.long()
        if self.per_step:
            w = tr.config.patch_size
            xp_l, xp_u = (tr.cast(tr._gather(xp_src, i, self.cols, w))
                          for i in (li, ui))
        else:
            xp_l, xp_u = (xp_src.index_select(0, i) for i in (li, ui))
        x_l, x_u = (x_src.index_select(0, i) for i in (li, ui))
        g = CounterStream(st["rng"], st["step"])
        d = tr._draws(g, xp_l, x_l, xp_u, x_u, ly)
        carry = st["carry"]

        def loss_fn(params):
            loss, metrics, writes = tr._losses(
                Apply(self.modules, params), d, ly, carry, epoch,
                batch_index, thr)
            return loss, (metrics, writes)

        grads, (_, (metrics, writes)) = grad_and_value(
            loss_fn, has_aux=True)(st["params"])
        params = st["params"]
        opts = []
        for opt, keys, hyper in zip(st["opts"], self.layout.opt_keys,
                                    self.hyper):
            params, new = adam_update(params, grads, opt, keys, hyper)
            opts.append(new)
        new_carry = {k: queue_write(c, *writes[k])
                     if isinstance(c, QueueState) else writes[k]
                     for k, c in carry.items()}
        new = dict(st, params=params, opts=opts, carry=new_carry,
                   step=st["step"] + 1)
        return self.layout.pack(new), metrics
