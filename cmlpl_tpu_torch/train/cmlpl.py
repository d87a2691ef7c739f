"""CMLPL trainer (``cmlpl_tpu/train/cmlpl.py``; reference ``train.py:146-289``).

One step: gather the labeled and unlabeled patches and spectra on the
device, draw the Gaussian views, run both BaseNet2s, smooth the pseudo
labels with the queues, compute the CMLPL losses, take ONE backward over
``total_b + total_e`` and step both Adams.  One backward equals the
reference's two (train.py:267, :271) because every cross-network term is
detached exactly where the JAX step puts ``stop_gradient``
(``cmlpl_tpu/train/cmlpl.py:308-353``): the softmax of both nets'
unlabeled logits, the features that go into the queues and the smoothing,
and the other net's side of each contrastive term.

The gathers, the step loop and ``fit`` are the shared driver's
(:mod:`cmlpl_tpu_torch.train.driver`).

The opt-in extras (``cmlpl_tpu/train/cmlpl.py:235-268,279-293,355-402``):
``augment`` transforms the gathered patches before the views are drawn;
``extra_loss`` adds ``extra_weight`` times an extra term to each net's
total and the metric ``extra_loss``; ``stack_nets`` runs both forwards as
one batched forward (``driver.stacked_forward``).

Random streams: every draw of a step comes from the state's
``torch.Generator``, on the training device, in a fixed order, all of
them in ``_draws``: the augmentations (labeled, then unlabeled), the
noise views, net B's then net E's dropout mask, the memory bank's
uniforms (pushed rows, anchors, negatives).  ``_losses`` draws nothing:
the bank's choices are made there from those uniforms
(``ops/noise.choose``), so a fused step draws them per seed before its
vmap and an exported step from its counter stream.
"""

from __future__ import annotations

import numpy as np
import torch

from cmlpl_tpu_torch.core import tp as tpc
from cmlpl_tpu_torch.data.augment import (mixture_noise, radiation_noise,
                                          random_flip, random_rot90)
from cmlpl_tpu_torch.objectives.cmlpl import (adaptive_threshold,
                                              graph_contrastive,
                                              pseudo_label_graph,
                                              soft_consistency)
from cmlpl_tpu_torch.objectives.contrastive import (MemoBankDraws,
                                                    memobank_contrastive,
                                                    memobank_draws,
                                                    memobank_init, nt_xent)
from cmlpl_tpu_torch.objectives.mmd import mmd_loss
from cmlpl_tpu_torch.objectives.queue import (memory_smooth, queue_init,
                                              queue_update)
from cmlpl_tpu_torch.objectives.supervised import cross_entropy
from cmlpl_tpu_torch.train.driver import TwoNetDriver
from cmlpl_tpu_torch.train.state import CMLPLConfig, CMLPLTrainState
from cmlpl_tpu_torch.weights import cmlpl_state_from_jax, cmlpl_state_to_jax

#: metric keys of a step (``cmlpl_tpu/train/cmlpl.py:392-400``); the
#: metric ``extra_loss`` is added when ``extra_loss`` is set
METRICS = ("loss_contrast", "total_loss", "cls_loss", "con_loss",
           "total_loss_e", "acc", "mask_rate")
EXTRA_LOSSES = ("", "memobank", "mmd", "ntxent")
AUGMENTS = ("flip", "rot90", "radiation", "mixture")
#: the memory bank's anchors per class and negatives per anchor
#: (``cmlpl_tpu/train/cmlpl.py:379-383``)
BANK_QUERIES, BANK_NEGATIVES = 32, 16


def median(x: torch.Tensor) -> torch.Tensor:
    """The median of the last axis, ``jnp.median``'s: the middle value,
    or the mean of the two middle values of an even count, taken from a
    sort as ``torch.quantile(x, 0.5)`` takes it (``lerp`` at 0.5), so the
    same bits; unlike ``quantile`` it has a batching rule and traces."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return torch.lerp(s[..., (n - 1) // 2], s[..., n // 2], 0.5)


def _when(cond, fn, other):
    """``fn()`` where ``cond`` holds, else ``other``: a Python branch for a
    bool, a ``torch.where`` over both for a 0-d tensor (a traced step's
    schedule), whose selected values are the branch's."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, fn(), other)
    return fn() if cond else other


class CMLPLTrainer(TwoNetDriver):
    """Builds the CMLPL state and runs its steps on ``device`` (the CUDA
    card unless the caller asks for the CPU), over the ranks of ``mesh``
    when given (``train/driver.EpochDriver``)."""

    def __init__(self, config: CMLPLConfig, device=None, mesh=None):
        if config.extra_loss not in EXTRA_LOSSES:
            raise ValueError(f"unknown extra_loss {config.extra_loss!r}; "
                             f"one of {EXTRA_LOSSES}")
        unknown = set(config.augment) - set(AUGMENTS)
        if unknown:
            raise ValueError(f"unknown augment {sorted(unknown)}; any of "
                             f"{AUGMENTS}")
        super().__init__(config, device, mesh)

    def new_state(self, params_b, params_e, run_seed: int
                  ) -> CMLPLTrainState:
        """A state from two BaseNet2 param trees in the JAX layout, fresh
        Adam states, queues and (``extra_loss="memobank"``) bank, and a
        generator seeded with ``run_seed``.  On a 2-D mesh the queues hold
        the rank's feature columns and the bank is replicated
        (``cmlpl_tpu/train/cmlpl.py:155-159``)."""
        cfg = self.config
        bank = None
        if cfg.extra_loss == "memobank":
            bank = memobank_init(cfg.num_classes, cfg.memobank_size,
                                 cfg.feat_dim, self.device)
        width = tpc.width(cfg.feat_dim, self.tp)
        return CMLPLTrainState(
            net_b=self._new_net(params_b), net_e=self._new_net(params_e),
            queue_w=queue_init(cfg.queue_size, width, cfg.num_classes,
                               self.device),
            queue_s=queue_init(cfg.queue_size, width, cfg.num_classes,
                               self.device),
            generator=torch.Generator(self.device).manual_seed(run_seed),
            bank=bank)

    def state_to_jax(self, state: CMLPLTrainState) -> dict:
        return cmlpl_state_to_jax(state)

    def state_from_jax(self, tree, run_seed: int = 0) -> CMLPLTrainState:
        return cmlpl_state_from_jax(tree, self, run_seed)

    def _augmented(self, g, xp, labels=None):
        """The configured augmentations of a patch batch, in the JAX
        package's order; mixture only where ``labels`` are given."""
        aug = self.config.augment
        if "flip" in aug:
            xp = random_flip(g, xp)
        if "rot90" in aug:
            xp = random_rot90(g, xp)
        if "radiation" in aug:
            xp = radiation_noise(g, xp)
        if "mixture" in aug and labels is not None:
            xp = mixture_noise(g, xp, labels)
        return xp

    def _carry(self, state: CMLPLTrainState) -> dict:
        carry = {"queue_w": state.queue_w, "queue_s": state.queue_s}
        if state.bank is not None:
            carry["bank"] = state.bank
        return carry

    def _run_extras(self) -> tuple:
        """``extra0``: the adaptive threshold of each epoch
        (``cmlpl_tpu/train/cmlpl.py:585-592``)."""
        cfg = self.config
        return (np.asarray([adaptive_threshold(e, cfg.num_epochs, cfg.thr)
                            for e in range(cfg.num_epochs)], np.float32),)

    def _draws(self, g, xp_l, x_l, xp_u, x_u, lab_y) -> dict:
        """The augmentations (labeled, then unlabeled), the noise views,
        net B's then net E's dropout mask, and under "memobank" the bank's
        uniforms (``"bank_<field>"`` of a ``MemoBankDraws``)."""
        cfg = self.config
        if cfg.augment:
            xp_l = self._augmented(g, xp_l, lab_y)
            xp_u = self._augmented(g, xp_u)
        d = self._views(g, xp_l, x_l, xp_u, x_u)
        if cfg.extra_loss == "memobank":
            u = memobank_draws(g, cfg.num_classes, xp_l.device,
                               num_queries=BANK_QUERIES,
                               num_negatives=BANK_NEGATIVES)
            d.update(("bank_" + k, v) for k, v in u._asdict().items())
        return d

    def _losses(self, apply, d, lab_y, carry, epoch, batch_index, thr=None):
        cfg = self.config
        bt = lab_y.shape[0]
        if thr is None:
            thr = adaptive_threshold(epoch, cfg.num_epochs, cfg.thr)
        if isinstance(epoch, torch.Tensor):
            warm = torch.logical_or(epoch > 0, batch_index > cfg.queue_batch)
        else:
            warm = epoch > 0 or batch_index > cfg.queue_batch
        onehot = (lab_y[:, None] == torch.arange(
            cfg.num_classes, device=lab_y.device)).float()

        (logits_b_all, feat_b_all), (logits_e_all, feat_e_all) = \
            self._forwards(apply, d)
        lab_b, un_b = logits_b_all[:bt], logits_b_all[bt:]
        feat_lab_b, xs = feat_b_all[:bt], feat_b_all[bt:]
        lab_e, un_e = logits_e_all[:bt], logits_e_all[bt:]
        feat_lab_e, xw = feat_e_all[:bt], feat_e_all[bt:]

        cls_b = cross_entropy(lab_b, lab_y)
        cls_e = cross_entropy(lab_e, lab_y)

        # ---- no-grad block (train.py:195-237) ----
        with torch.no_grad():
            probs_orig = torch.softmax(un_e.detach(), dim=1)
            probs_orig1 = torch.softmax(un_b.detach(), dim=1)
            # smoothing reads the queues, which the step writes after
            # the update
            probs = _when(warm, lambda: memory_smooth(
                xw.detach(), probs_orig, carry["queue_w"], cfg.alpha,
                cfg.temperature, self.tp), probs_orig)
            probs1 = _when(warm, lambda: memory_smooth(
                xs.detach(), probs_orig1, carry["queue_s"], cfg.alpha,
                cfg.temperature, self.tp), probs_orig1)
            mask = (probs.max(dim=1).values >= thr).float()
            masks = (probs1.max(dim=1).values >= thr).float()
            # [other-net unlabeled feats, own labeled feats] with the
            # pre-smoothing probs / one-hot labels (train.py:223-237)
            writes = {"queue_w": (torch.cat([xw.detach(),
                                             feat_lab_b.detach()]),
                                  torch.cat([probs_orig, onehot])),
                      "queue_s": (torch.cat([xs.detach(),
                                             feat_lab_e.detach()]),
                                  torch.cat([probs_orig1, onehot]))}
            q, qn = pseudo_label_graph(probs1, probs)

        # ---- consistency (train.py:239-242) ----
        con_b = soft_consistency(un_b, probs, mask)
        con_e = soft_consistency(un_e, probs1, masks)
        # ---- contrastive pseudo-label graph (train.py:243-265) ----
        contrast_b = graph_contrastive(xs, xw.detach(), q, qn,
                                       cfg.temperature)
        contrast_e = graph_contrastive(xs.detach(), xw, q, qn,
                                       cfg.temperature)

        total_b = cls_b + cfg.w_contrast * contrast_b \
            + cfg.w_consistency * con_b
        total_e = cls_e + cfg.w_contrast * contrast_e \
            + cfg.w_consistency * con_e
        if cfg.extra_loss:
            extra_b, extra_e, bank = self._extra(
                carry.get("bank"), d, probs, xs, xw, feat_lab_b, feat_lab_e)
            total_b = total_b + cfg.extra_weight * extra_b
            total_e = total_e + cfg.extra_weight * extra_e
            if bank is not None:
                writes["bank"] = bank

        with torch.no_grad():
            acc_e = (lab_e.argmax(dim=1) == lab_y).float().mean()
        metrics = {"loss_contrast": contrast_b.detach(),
                   "total_loss": total_b.detach(),
                   "cls_loss": cls_b.detach(), "con_loss": con_b.detach(),
                   "total_loss_e": total_e.detach(), "acc": acc_e,
                   "mask_rate": mask.mean()}
        if cfg.extra_loss:
            metrics["extra_loss"] = extra_b.detach()
        return total_b + total_e, metrics, writes

    @torch.no_grad()
    def _write(self, carry: dict, writes: dict) -> None:
        for name in ("queue_w", "queue_s"):
            queue_update(carry[name], *writes[name], tp=self.tp)
        if "bank" in writes:
            for field in ("feats", "count", "ptr"):
                getattr(carry["bank"], field).copy_(
                    getattr(writes["bank"], field))

    def _extra(self, bank, d, probs, xs, xw, feat_lab_b, feat_lab_e):
        """(net B's, net E's) extra term (``cmlpl_tpu/train/cmlpl.py``
        ``:355-388``), and the new bank under "memobank" (else None), whose
        choices the bank's uniforms in the draws ``d`` make."""
        cfg = self.config
        if cfg.extra_loss == "ntxent":
            # the two nets' views of the same unlabeled samples
            return (nt_xent(xs, xw.detach(), cfg.temperature),
                    nt_xent(xs.detach(), xw, cfg.temperature), None)
        if cfg.extra_loss == "mmd":
            # labeled vs unlabeled feature distributions, per net
            return mmd_loss(feat_lab_b, xs), mmd_loss(feat_lab_e, xw), None
        # U2PL InfoNCE: net E (the smoothed probs) teaches net B; the
        # reference's percentile entropy split is a median split
        ent = -torch.sum(probs * torch.log(probs + 1e-10), dim=1)
        med = median(ent)
        extra_b, bank = memobank_contrastive(
            xs, xw.detach(), probs, probs.argmax(dim=1), ent <= med,
            ent > med, bank,
            MemoBankDraws(*(d["bank_" + k] for k in MemoBankDraws._fields)),
            temperature=0.5)
        return extra_b, torch.zeros((), device=xs.device), bank

    # ------------------------------------------------------------------ #
    def _format_log(self, epoch, batch_index, num_batches, m):
        cfg = self.config
        return (f"Epoch {epoch + 1}/{cfg.num_epochs}: "
                f"{batch_index + 1}/{num_batches} "
                f"loss_contrast={m['loss_contrast']:.2f} "
                f"total_loss={m['total_loss']:.4f} "
                f"cls_loss={m['cls_loss']:.4f} "
                f"con_loss={m['con_loss']:.4f} "
                f"acc={m['acc'] * 100:.2f}")
