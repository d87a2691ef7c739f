"""The trainers' shared driver (``cmlpl_tpu/train/driver.py:30-58,219-273``):
the gather set-up, the step loop and ``fit``, common to CMLPL, CPS and CCT.

A subclass provides ``init_state``, ``_format_log`` and its step in two
parts: ``_draws`` (every random draw of the step, from one seed's
generator, in the step's order) and ``_losses`` (the rest, through
:class:`Apply`, so the same code runs on a state's modules or, under
``torch.func.vmap``, on one seed's slice of stacked params); ``_modules``,
``_opts``, ``_carry`` and ``_write`` name the state's parts.

Gathers (``CMLPLConfig.gather_impl``): in "pool" mode, the default at the
reference schedule, the unique pixels of one call (a run, an epoch or a
step) are gathered once (``ops/patch_gather.gather_pool``): by CUDA
kernel 1 in f32, or by kernel 2 from a bf16 cube when the inputs are bf16
(``compute_dtype="bfloat16"`` with ``input_dtype="compute"``); every step
takes its rows by position.  "pallas" and "pallas_bf16" launch a kernel
twice a step; "xla" is the plain gather.  An "auto" whose pool is over the
budget takes "pallas" on the card and "xla" on the CPU.  Patches and
spectra are cast to the input dtype (``make_input_cast``), and the noise
views are drawn in it.  Patches are inputs: nothing differentiates through
a gather.

Precision: a call's steps run with TF32 off, so the loss, queue and Adam
math stays f32 under either compute dtype; a bf16 model's forward sets
the switches for its own layers (``device.compute_precision``).

The port runs every step from a Python loop.  What stays from the JAX
driver is how much one call of the trainer covers, because that sets how
often the host draws batches and, in pool mode, how often the pool is
gathered: with no per-epoch host work (no resume, no ``on_epoch_end``
hook) and more than one epoch, :meth:`EpochDriver.fit` draws the whole
schedule up front and runs it as one call (one pool per run); otherwise
one call per epoch (one pool per epoch).  The sampler is drawn in the same
order either way, and as in the JAX package.

Metrics stay on the device until the call ends and then come back in one
copy; the history is a list of dicts of floats, one per step.

An exported training run (``utils/export.build_run_exported``) runs the
same ``_draws`` and ``_losses`` as one program: ``train/functional.py``
steps the state's tensors functionally, and a trainer names where its
parts sit in the JAX state (``JAX_PARAMS``, ``JAX_OPTS``), what a run
program cannot replay (``_check_run_exportable``) and its per-run inputs
(``_run_extras``).

Fused multi-seed runs (:meth:`EpochDriver.train_multi_run`, the JAX
package's ``cmlpl_tpu/train/driver.py:149-207``): N seeds' runs as one
step loop over a :class:`SeedStack`.  Each parameter is one leaf of shape
(N, ...), and each Adam of a state is one Adam over such leaves: Adam is
elementwise with one step count, so it is N Adams.  A step draws each
seed's randoms from that seed's generator outside the vmap (``_draws``),
runs ``_losses`` for all seeds as one ``vmap`` (each convolution one
grouped convolution, each product one batched product), takes ONE
backward over the sum of the seeds' losses (each seed's gradient is its
own) and writes the queues once for all seeds.  CMLPL's memory bank is
carried stacked too: unlike the queues' one pointer, its counts and
pointers are per seed, so they are vmapped with its rows.  Each seed's
pool is padded to one length with its first id, and the pools are
gathered as one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import functional_call, vmap

from cmlpl_tpu_torch.data.prep import PreparedScene
from cmlpl_tpu_torch.device import compute_precision, resolve_device
from cmlpl_tpu_torch.models.basenet import BaseNet2, joint_dim, keep_mask
from cmlpl_tpu_torch.objectives.queue import QueueState
from cmlpl_tpu_torch.ops.noise import make_noiser, two_net_views
from cmlpl_tpu_torch.ops.patch_gather import (gather_pool,
                                              make_input_cast,
                                              make_train_gather,
                                              poolify_batches,
                                              resolve_train_gather)
from cmlpl_tpu_torch.train.state import CMLPLConfig, NetState
from cmlpl_tpu_torch.weights import init_basenet2_params, state_dict_from_jax


def stack_schedule(sampler, num_epochs: int):
    """Pre-draw every epoch's shuffled batches -> three (E, N, B) arrays
    (labeled idx, labeled y, unlabeled idx)."""
    epochs = []
    for _ in range(num_epochs):
        batches = list(sampler.epoch())
        epochs.append(tuple(np.stack([b[i] for b in batches])
                            for i in range(3)))
    return tuple(np.stack([e[i] for e in epochs]) for i in range(3))


def seed_pools(li, ui):
    """Pool-mode host prep of a seed-stacked schedule (S, ...): each seed's
    pool (``poolify_batches``), padded to the longest with its own first
    id (``cmlpl_tpu/train/driver.py:183-196``), as one flat pool of S
    equal blocks, and the batch ids as positions into it.  One seed gives
    ``poolify_batches``'s pool."""
    pools, lis, uis = zip(*(poolify_batches(a, b) for a, b in zip(li, ui)))
    plen = max(len(p) for p in pools)
    pool = np.concatenate([np.concatenate(
        [p, np.full(plen - len(p), p[0], p.dtype)]) for p in pools])
    offset = (np.arange(len(pools), dtype=np.int32) * plen).reshape(
        (-1,) + (1,) * (np.ndim(lis[0])))
    return pool, np.stack(lis) + offset, np.stack(uis) + offset


class Apply:
    """Calls a state's modules by path (``"net_b"``, ``"model.encoder"``):
    with their own params, or, given ``params`` (full name -> tensor, as
    :meth:`EpochDriver.named_params` names them), through
    ``torch.func.functional_call`` with those, as a fused run does for one
    seed inside its vmap."""

    def __init__(self, modules: torch.nn.ModuleDict, params=None):
        self.modules = modules
        self.params = params

    def _params(self, path: str) -> dict:
        prefix = path + "."
        return {k[len(prefix):]: v for k, v in self.params.items()
                if k.startswith(prefix)}

    def __call__(self, path: str, *args, **kwargs):
        module = self.modules.get_submodule(path)
        if self.params is None:
            return module(*args, **kwargs)
        return functional_call(module, self._params(path), args, kwargs)

    def stacked(self, paths, xps, xs, keeps=None):
        """The same-architecture modules at ``paths`` as ONE batched
        forward over their stacked params (:func:`stacked_forward`)."""
        mods = [self.modules.get_submodule(p) for p in paths]
        params = ([dict(m.named_parameters()) for m in mods]
                  if self.params is None else
                  [self._params(p) for p in paths])
        return stacked_forward(mods[0], params, xps, xs, keeps)


def stacked_forward(module, params, xps, xs, keeps=None):
    """``module`` under each of the param dicts ``params`` as ONE batched
    forward: a ``torch.func.vmap`` of ``functional_call`` over the params
    stacked on a leading axis, so each conv and product runs once at the
    batch times their number.  ``torch.stack`` is differentiable, so the
    gradients reach each dict's own params.  ``keeps``: the dropout masks,
    stacked, drawn by the caller (nothing random runs inside the vmap).
    Returns the (logits, feat) of each, stacked."""
    stacked = {n: torch.stack([p[n] for p in params]) for n in params[0]}

    def one(p, xp, x, keep):
        return functional_call(module, p, (xp, x), {"keep": keep})

    return vmap(one, in_dims=(0, 0, 0, None if keeps is None else 0))(
        stacked, torch.stack(xps), torch.stack(xs), keeps)


@dataclasses.dataclass
class SeedStack:
    """N seeds' trainer states as one (:meth:`EpochDriver.stack_states`):
    each parameter one (N, ...) leaf under one Adam per Adam of a state,
    the carried state (CMLPL's queues and bank) stacked the same way, and
    the seeds' own generators.  ``states`` are the seeds' states, written
    back by :meth:`EpochDriver.unstack`."""
    states: list
    params: dict              # full name -> (N, ...) leaf
    opts: list                # torch.optim.Adam over the leaves
    carry: dict               # name -> stacked QueueState or MemoBankState
    modules: torch.nn.ModuleDict  # seed 0's modules: the architecture
    step: int = 0


class EpochDriver:
    """Base of the trainers: resolves the device and the training gather,
    runs the steps of a call and the epochs of a run."""

    def __init__(self, config: CMLPLConfig, device=None):
        self.cast = make_input_cast(config.compute_dtype, config.input_dtype)
        self.device = resolve_device(device)
        config = dataclasses.replace(config, gather_impl=resolve_train_gather(
            config.gather_impl, self.device, num_unlabel=config.num_unlabel,
            patch_size=config.patch_size, n_pc=config.n_pc,
            num_labeled=config.num_label * config.num_classes))
        self.config = config
        self.noisy = make_noiser(config.noise_impl, config.noise)
        if config.gather_impl != "pool":
            self._prep_cube, self._gather = make_train_gather(
                config.gather_impl, config.n_pc)

    # -- the parts of a step, per trainer --------------------------------- #
    def _modules(self, state) -> dict:
        """The state's trained modules by name."""
        raise NotImplementedError

    def _opts(self, state) -> tuple:
        """The state's Adams, in the order they step."""
        raise NotImplementedError

    def _carry(self, state) -> dict:
        """What a step reads and writes besides the params (CMLPL's
        queues and bank), by name."""
        return {}

    def _draws(self, g, xp_l, x_l, xp_u, x_u, lab_y) -> dict:
        """Every random draw of a step from generator ``g``, in the step's
        order, and what is made of them before the forwards (the views):
        a dict of tensors."""
        raise NotImplementedError

    def _losses(self, apply: Apply, d: dict, lab_y, carry: dict,
                epoch, batch_index, thr=None):
        """The rest of a step on the draws ``d``: (the loss to minimise,
        its metrics as 0-d tensors, the rows to write into ``carry``).  It
        draws nothing: a serial, a fused and a traced step all run it on
        draws made before it.
        ``epoch`` and ``batch_index`` are ints, or 0-d tensors in a traced
        step (``train/functional.py``), which then passes CMLPL's adaptive
        threshold as ``thr`` (else computed from ``epoch``)."""
        raise NotImplementedError

    def _write(self, carry: dict, writes: dict) -> None:
        """Writes a step's ``writes`` into ``carry``, after the update."""

    def _step(self, state, xp_l, x_l, xp_u, x_u, lab_y, epoch: int,
              batch_index: int) -> dict:
        """One optimisation step on the labeled and unlabeled patches and
        spectra; returns its metrics as 0-d device tensors."""
        g = state.generator
        d = self._draws(g, xp_l, x_l, xp_u, x_u, lab_y)
        carry = self._carry(state)
        loss, metrics, writes = self._losses(
            Apply(torch.nn.ModuleDict(self._modules(state))), d, lab_y,
            carry, epoch, batch_index)
        self._update(state, loss, *self._opts(state))
        self._write(carry, writes)
        return metrics

    def _multi_step(self, ms: SeedStack, xp_l, x_l, xp_u, x_u, lab_y,
                    epoch: int, batch_index: int) -> dict:
        """One step of every seed of ``ms`` on seed-stacked inputs (S, B,
        ...); returns metrics stacked (S,)."""
        draws = [self._draws(st.generator, *(a[i] for a in (
            xp_l, x_l, xp_u, x_u, lab_y))) for i, st in enumerate(ms.states)]
        # the seed axis next to the last (the channels of an NHWC patch):
        # the vmapped convolutions fold it into their channels, and there
        # a (B, H, W, S, C) patch is a channels-last (B, S*C, H, W) view,
        # no copy, as the serial step's patches are channels-last
        draws = {k: torch.stack([d[k] for d in draws], dim=-2)
                 for k in draws[0]}
        seed_dims = {k: v.dim() - 2 for k, v in draws.items()}
        # a queue's tensors (its pointer is shared); a bank as it is
        carried = {k: (c.feats, c.probs) if isinstance(c, QueueState) else c
                   for k, c in ms.carry.items()}

        def one(params, d, y, cs):
            carry = {k: QueueState(*c, ms.carry[k].ptr)
                     if isinstance(ms.carry[k], QueueState) else c
                     for k, c in cs.items()}
            return self._losses(Apply(ms.modules, params), d, y, carry,
                                epoch, batch_index)

        loss, metrics, writes = vmap(one, in_dims=(0, seed_dims, 0, 0))(
            ms.params, draws, lab_y, carried)
        self._update(ms, loss.sum(), *ms.opts)
        self._write(ms.carry, writes)
        return metrics

    @staticmethod
    def _update(state, loss: torch.Tensor, *opts) -> None:
        """ONE backward over ``loss``, then each Adam steps in the given
        order, and the state's step count advances."""
        for opt in opts:
            opt.zero_grad(set_to_none=True)
        loss.backward()
        for opt in opts:
            opt.step()
        state.step += 1

    def _run(self, state, scene: PreparedScene, li, ly, ui, epochs,
             first_batch: int = 0):
        """Steps over (E, N, B) id arrays, epoch ``epochs[e]`` for row e;
        step i of a row has batch index ``first_batch + i``.  Returns
        (state, metrics stacked (E, N) on the device).  For a
        :class:`SeedStack` the arrays are (S, E, N, B), one row a seed, and
        the metrics (S, E, N)."""
        cfg = self.config
        dev = self.device
        cast = self.cast
        w, cols = cfg.patch_size, scene.cols
        multi = isinstance(state, SeedStack)
        if not multi:
            li, ly, ui = (np.asarray(a)[None] for a in (li, ly, ui))
        if cfg.gather_impl == "pool":
            pool, li, ui = seed_pools(li, ui)
            xp_src, x_src = gather_pool(
                cast(scene.padded_pca), scene.spectra,
                torch.from_numpy(pool).to(dev), cols=cols, w=w)
            x_src = cast(x_src)

            def gather_xp(src, pos):
                return src.index_select(0, pos)
        else:
            xp_src = self._prep_cube(scene.padded_pca)
            x_src = cast(scene.spectra)

            def gather_xp(src, ids):
                return cast(self._gather(src, ids, cols, w))

        def gather_x(src, ids):
            return src.index_select(0, ids)

        li, ui = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                  for a in (li, ui))
        ly = torch.from_numpy(np.asarray(ly, np.int64)).to(dev)
        seeds = li.shape[0]

        def batch(gather, src, ids):
            # the seeds' rows in one gather, then a leading seed axis
            out = gather(src, ids.reshape(-1))
            return out.view(seeds, -1, *out.shape[1:])

        rows = []
        with compute_precision("float32"):
            for e, epoch in enumerate(epochs):
                row = []
                for i in range(li.shape[2]):
                    lab, unl = li[:, e, i], ui[:, e, i]
                    inputs = (batch(gather_xp, xp_src, lab),
                              batch(gather_x, x_src, lab),
                              batch(gather_xp, xp_src, unl),
                              batch(gather_x, x_src, unl), ly[:, e, i])
                    if multi:
                        row.append(self._multi_step(
                            state, *inputs, epoch, first_batch + i))
                    else:
                        row.append(self._step(
                            state, *(a[0] for a in inputs), epoch,
                            first_batch + i))
                rows.append(row)
        metrics = {k: torch.stack([torch.stack([m[k] for m in row])
                                   for row in rows]) for k in rows[0][0]}
        if multi:
            metrics = {k: v.movedim(-1, 0) for k, v in metrics.items()}
        return state, metrics

    # ------------------------------------------------------------------ #
    def train_step(self, state, scene: PreparedScene, lab_idx, lab_y,
                   unl_idx, epoch: int = 0, batch_index: int = 0):
        """One optimisation step.  ``epoch``/``batch_index`` drive CMLPL's
        adaptive threshold and queue warm-up (train.py:147-148, :212); CPS
        and CCT ignore them.  Returns (state, metrics of 0-d tensors)."""
        state, m = self._run(state, scene, np.asarray(lab_idx)[None, None],
                             np.asarray(lab_y)[None, None],
                             np.asarray(unl_idx)[None, None], [epoch],
                             first_batch=batch_index)
        return state, {k: v[0, 0] for k, v in m.items()}

    def train_epoch(self, state, scene: PreparedScene, lab_idx, lab_y,
                    unl_idx, epoch: int = 0):
        """One epoch; batch arrays are stacked (num_batches, batch).
        Returns (state, metrics stacked (N,))."""
        state, m = self._run(state, scene, np.asarray(lab_idx)[None],
                             np.asarray(lab_y)[None],
                             np.asarray(unl_idx)[None], [epoch])
        return state, {k: v[0] for k, v in m.items()}

    def train_run(self, state, scene: PreparedScene, sampler):
        """The whole schedule, drawn up front from the sampler (the same
        host draws as epoch by epoch).  Returns (state, metrics stacked
        (E, N))."""
        li, ly, ui = stack_schedule(sampler, self.config.num_epochs)
        return self._run(state, scene, li, ly, ui,
                         range(self.config.num_epochs))

    # -- fused multi-seed runs -------------------------------------------- #
    def named_params(self, state) -> dict:
        """The state's parameters by full name (``"<module>.<param>"``)."""
        return {f"{m}.{n}": p for m, mod in self._modules(state).items()
                for n, p in mod.named_parameters()}

    def stack_states(self, states) -> SeedStack:
        """The seeds' ``states`` as one :class:`SeedStack`: stacked copies
        of their params, Adam moments (where a state has them) and
        carried tensors; all must be at the same step."""
        if len({st.step for st in states}) != 1:
            raise ValueError("the seeds' states are at different steps")
        named = [self.named_params(st) for st in states]
        params = {n: torch.stack([p[n].detach() for p in named])
                  .requires_grad_(True) for n in named[0]}
        name_of = {id(p): n for n, p in named[0].items()}
        opts = []
        for k, opt0 in enumerate(self._opts(states[0])):
            keys = [name_of[id(p)] for group in opt0.param_groups
                    for p in group["params"]]
            opt = torch.optim.Adam([params[n] for n in keys],
                                   **opt0.defaults)
            for n in keys:
                moments = [self._opts(st)[k].state.get(nm[n])
                           for st, nm in zip(states, named)]
                if moments[0]:
                    opt.state[params[n]] = {
                        "step": moments[0]["step"].clone(),
                        **{m: torch.stack([mo[m] for mo in moments])
                           for m in ("exp_avg", "exp_avg_sq")}}
            opts.append(opt)
        carries = [self._carry(st) for st in states]
        carry = {}
        for k, c in carries[0].items():
            if isinstance(c, QueueState):
                carry[k] = QueueState(
                    torch.stack([cs[k].feats for cs in carries]),
                    torch.stack([cs[k].probs for cs in carries]), c.ptr)
            else:
                carry[k] = type(c)(*(torch.stack(f) for f in zip(
                    *(cs[k] for cs in carries))))
        return SeedStack(list(states), params, opts, carry,
                         torch.nn.ModuleDict(self._modules(states[0])),
                         states[0].step)

    @torch.no_grad()
    def unstack(self, ms: SeedStack) -> list:
        """Writes ``ms`` back into its seeds' states and returns them: seed
        i's params, Adam moments, carried tensors and step."""
        for i, st in enumerate(ms.states):
            named = self.named_params(st)
            name_of = {id(p): n for n, p in named.items()}
            for n, p in named.items():
                p.copy_(ms.params[n][i])
            for opt, sopt in zip(ms.opts, self._opts(st)):
                for group in sopt.param_groups:
                    for p in group["params"]:
                        mo = opt.state.get(ms.params[name_of[id(p)]])
                        if mo:
                            sopt.state[p] = {
                                "step": mo["step"].clone(),
                                "exp_avg": mo["exp_avg"][i].clone(),
                                "exp_avg_sq": mo["exp_avg_sq"][i].clone()}
            for k, c in self._carry(st).items():
                if isinstance(c, QueueState):
                    c.feats.copy_(ms.carry[k].feats[i])
                    c.probs.copy_(ms.carry[k].probs[i])
                    c.ptr = ms.carry[k].ptr
                else:
                    for t, stacked in zip(c, ms.carry[k]):
                        t.copy_(stacked[i])
            st.step = ms.step
        return ms.states

    def _check_run_exportable(self) -> None:
        """Raises NotImplementedError for what an exported training run
        cannot replay (``utils/export.build_run_exported``): it gathers
        the pool once, so it needs the pool mode."""
        if self.config.gather_impl != "pool":
            raise NotImplementedError(
                "an exported training run gathers its pool once: it needs "
                f"gather_impl 'pool' (or 'auto' resolving to it), not "
                f"{self.config.gather_impl!r}")

    def _run_extras(self) -> tuple:
        """The run program's per-run inputs after the schedule
        (``extra0``, ...), as the JAX trainer's ``_run_extras``."""
        return ()

    def train_multi_run(self, seed, scene: PreparedScene, sampler,
                        num_iters: int, states=None):
        """ALL ``num_iters`` runs as ONE step loop over seed-stacked states
        (:class:`SeedStack`), equal to the serial CLI loop within the
        rounding of the batched convolutions and products: seed i starts
        from ``init_state((seed, i))`` (or ``states[i]``, when given), the
        schedules are drawn iter-major from the one host sampler (seed 0's
        whole schedule first), and each seed's draws come from its own
        generator in the serial step's order.  Returns (the seeds' states,
        in order; metrics stacked (S, E, N))."""
        if states is None:
            states = [self.init_state((seed, i)) for i in range(num_iters)]
        if len(states) != num_iters:
            raise ValueError(f"{len(states)} states for {num_iters} runs")
        scheds = [stack_schedule(sampler, self.config.num_epochs)
                  for _ in range(num_iters)]
        li, ly, ui = (np.stack([s[j] for s in scheds]) for j in range(3))
        ms, metrics = self._run(self.stack_states(states), scene, li, ly,
                                ui, range(self.config.num_epochs))
        return self.unstack(ms), metrics

    def fit(self, state, scene, sampler, *, log_every: int = 10,
            log_fn=print, start_epoch: int = 0, on_epoch_end=None):
        """Train from ``start_epoch`` to the config's last epoch; returns
        (state, history).  ``on_epoch_end(epoch, state)`` runs after each
        epoch."""
        cfg = self.config
        history = []
        if start_epoch == 0 and on_epoch_end is None and cfg.num_epochs > 1:
            state, stacked = self.train_run(state, scene, sampler)
            stacked = {k: np.asarray(v.tolist()) for k, v in stacked.items()}
            e, n = next(iter(stacked.values())).shape
            for ep in range(e):
                history.extend({k: float(v[ep, i])
                                for k, v in stacked.items()}
                               for i in range(n))
                if log_every:
                    log_fn(self._format_log(ep, n - 1, n, {
                        k: float(np.mean(v[ep, -log_every:]))
                        for k, v in stacked.items()}))
            return state, history

        for epoch in range(start_epoch, cfg.num_epochs):
            li, ly, ui = (np.stack(a) for a in zip(*sampler.epoch()))
            state, stacked = self.train_epoch(state, scene, li, ly, ui,
                                              epoch)
            stacked = {k: np.asarray(v.tolist()) for k, v in stacked.items()}
            n = li.shape[0]
            history.extend({k: float(v[i]) for k, v in stacked.items()}
                           for i in range(n))
            if log_every:
                for b in range(log_every - 1, n, log_every):
                    lo = b - log_every + 1
                    log_fn(self._format_log(epoch, b, n, {
                        k: float(np.mean(v[lo:b + 1]))
                        for k, v in stacked.items()}))
            if on_epoch_end is not None:
                on_epoch_end(epoch, state)
        return state, history


class TwoNetDriver(EpochDriver):
    """The dual-BaseNet2 trainers (CMLPL, CPS): each net is a BaseNet2 with
    its own Adam, built from a JAX-layout param tree."""

    #: where each module's params and each Adam's (module, optax state)
    #: sit in the JAX state tree (``train/functional.StateLayout``)
    JAX_PARAMS = {"net_b": ("net_b", "params"),
                  "net_e": ("net_e", "params")}
    JAX_OPTS = (("net_b", ("net_b", "opt_state", "0")),
                ("net_e", ("net_e", "opt_state", "0")))

    def _new_net(self, params) -> NetState:
        cfg = self.config
        model = BaseNet2(num_features=cfg.num_features, dropout=cfg.dropout,
                         num_classes=cfg.num_classes, n_pc=cfg.n_pc,
                         patch_size=cfg.patch_size,
                         compute_dtype=cfg.compute_dtype)
        model.load_state_dict(state_dict_from_jax(params))
        model = model.to(self.device).train()
        # torch's Adam defaults are optax.adam's: b1 0.9, b2 0.999,
        # eps 1e-8 outside the square root, bias-corrected
        return NetState(model, torch.optim.Adam(model.parameters(),
                                                lr=cfg.lr))

    def init_state(self, seed):
        """A fresh state from ``seed`` (an int or a sequence of ints, as
        ``numpy.random.SeedSequence`` takes): both nets' weights with
        torch-default init bounds, and the run's generator."""
        cfg = self.config
        k_b, k_e, k_run = np.random.SeedSequence(seed).spawn(3)
        shape = dict(n_pc=cfg.n_pc, num_features=cfg.num_features,
                     num_classes=cfg.num_classes, patch_size=cfg.patch_size)
        return self.new_state(init_basenet2_params(k_b, **shape),
                              init_basenet2_params(k_e, **shape),
                              int(k_run.generate_state(1)[0]))

    def _modules(self, state) -> dict:
        return {"net_b": state.net_b.model, "net_e": state.net_e.model}

    def _opts(self, state) -> tuple:
        return state.net_b.opt, state.net_e.opt

    def _views(self, g, xp_l, x_l, xp_u, x_u) -> dict:
        """The four noise views (net B patches/spectra, net E
        patches/spectra), then net B's and net E's dropout masks, the
        order in which two forwards would draw them."""
        cfg = self.config
        xp_b, x_b, xp_e, x_e = two_net_views(
            self.noisy, cfg.noise_fused, g, xp_l, x_l, xp_u, x_u)
        d = {"xp_b": xp_b, "x_b": x_b, "xp_e": xp_e, "x_e": x_e}
        if 0 < cfg.dropout < 1:
            shape = (xp_b.shape[0], joint_dim(cfg.patch_size))
            d["keep_b"], d["keep_e"] = (
                keep_mask(shape, cfg.dropout, g, xp_b.device)
                for _ in range(2))
        return d

    def _forwards(self, apply: Apply, d: dict):
        """((logits, feat) of net B, of net E) on the views of ``d``: two
        forwards, or one stacked forward (``stack_nets``)."""
        keep_b, keep_e = d.get("keep_b"), d.get("keep_e")
        if not self.config.stack_nets:
            return (apply("net_b", d["xp_b"], d["x_b"], keep=keep_b),
                    apply("net_e", d["xp_e"], d["x_e"], keep=keep_e))
        keeps = None if keep_b is None else torch.stack([keep_b, keep_e])
        logits, feat = apply.stacked(("net_b", "net_e"),
                                     (d["xp_b"], d["xp_e"]),
                                     (d["x_b"], d["x_e"]), keeps)
        return (logits[0], feat[0]), (logits[1], feat[1])
