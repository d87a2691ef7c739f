"""Epoch/fit driver (``cmlpl_tpu/train/driver.py:30-39,219-273``).

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

import numpy as np


def stack_schedule(sampler, num_epochs: int):
    """Pre-draw every epoch's shuffled batches -> three (E, N, B) arrays
    (labeled idx, labeled y, unlabeled idx)."""
    epochs = []
    for _ in range(num_epochs):
        batches = list(sampler.epoch())
        epochs.append(tuple(np.stack([b[i] for b in batches])
                            for i in range(3)))
    return tuple(np.stack([e[i] for e in epochs]) for i in range(3))


class EpochDriver:
    """Mixin: the epoch/batch loop.  Subclasses provide ``config``,
    ``train_run``, ``train_epoch`` and ``_format_log``."""

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
