"""The trainers' shared driver (``cmlpl_tpu/train/driver.py:30-58,219-273``):
the gather set-up, the step loop and ``fit``, common to CMLPL, CPS and CCT.

A subclass provides ``_step`` (one optimisation step on the gathered
patches and spectra), ``init_state`` and ``_format_log``.

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
``train_multi_run`` (fused multi-seed runs) waits for ROADMAP item 10.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cmlpl_tpu_torch.data.prep import PreparedScene
from cmlpl_tpu_torch.device import compute_precision, resolve_device
from cmlpl_tpu_torch.models.basenet import BaseNet2
from cmlpl_tpu_torch.ops.noise import make_noiser
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


def not_ported(what: str, item: int, name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md section 1, item {item} "
        f"({name})")


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

    def _step(self, state, xp_l, x_l, xp_u, x_u, lab_y, epoch: int,
              batch_index: int) -> dict:
        """One optimisation step on the labeled and unlabeled patches and
        spectra; returns its metrics as 0-d device tensors."""
        raise NotImplementedError

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
        (state, metrics stacked (E, N) on the device)."""
        cfg = self.config
        dev = self.device
        cast = self.cast
        w, cols = cfg.patch_size, scene.cols
        if cfg.gather_impl == "pool":
            pool, li, ui = poolify_batches(li, ui)
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

        li, ui = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                  for a in (li, ui))
        ly = torch.from_numpy(np.asarray(ly, np.int64)).to(dev)
        rows = []
        with compute_precision("float32"):
            for e, epoch in enumerate(epochs):
                row = []
                for i in range(li.shape[1]):
                    lab, unl = li[e, i], ui[e, i]
                    row.append(self._step(
                        state, gather_xp(xp_src, lab),
                        x_src.index_select(0, lab), gather_xp(xp_src, unl),
                        x_src.index_select(0, unl), ly[e, i], epoch,
                        first_batch + i))
                rows.append(row)
        return state, {k: torch.stack([torch.stack([m[k] for m in row])
                                       for row in rows])
                       for k in rows[0][0]}

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
