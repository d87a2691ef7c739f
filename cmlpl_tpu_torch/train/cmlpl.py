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

Random streams: the noise views and both dropout masks come from the
state's ``torch.Generator``, on the training device, in a fixed order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cmlpl_tpu_torch.objectives.cmlpl import (adaptive_threshold,
                                              graph_contrastive,
                                              pseudo_label_graph,
                                              soft_consistency)
from cmlpl_tpu_torch.objectives.queue import (memory_smooth, queue_init,
                                              queue_update)
from cmlpl_tpu_torch.objectives.supervised import cross_entropy
from cmlpl_tpu_torch.ops.noise import two_net_views
from cmlpl_tpu_torch.train.driver import TwoNetDriver, not_ported
from cmlpl_tpu_torch.train.state import CMLPLConfig, CMLPLTrainState

#: metric keys of a step (``cmlpl_tpu/train/cmlpl.py:392-400``)
METRICS = ("loss_contrast", "total_loss", "cls_loss", "con_loss",
           "total_loss_e", "acc", "mask_rate")


class CMLPLTrainer(TwoNetDriver):
    """Builds the CMLPL state and runs its steps on ``device`` (the CUDA
    card unless the caller asks for the CPU)."""

    def __init__(self, config: CMLPLConfig, device=None):
        if config.extra_loss or config.augment or config.stack_nets:
            raise not_ported("extra_loss, augment and stack_nets", 9,
                             "Extras")
        super().__init__(config, device)

    def new_state(self, params_b, params_e, run_seed: int
                  ) -> CMLPLTrainState:
        """A state from two BaseNet2 param trees in the JAX layout, fresh
        Adam states and queues, and a generator seeded with ``run_seed``."""
        cfg = self.config
        return CMLPLTrainState(
            net_b=self._new_net(params_b), net_e=self._new_net(params_e),
            queue_w=queue_init(cfg.queue_size, cfg.feat_dim,
                               cfg.num_classes, self.device),
            queue_s=queue_init(cfg.queue_size, cfg.feat_dim,
                               cfg.num_classes, self.device),
            generator=torch.Generator(self.device).manual_seed(run_seed))

    def _step(self, state: CMLPLTrainState, xp_l, x_l, xp_u, x_u, lab_y,
              epoch: int, batch_index: int) -> dict:
        cfg = self.config
        g = state.generator
        bt = lab_y.shape[0]
        net_b, net_e = state.net_b.model, state.net_e.model
        adap_mask_thr = adaptive_threshold(epoch, cfg.num_epochs, cfg.thr)
        warm = epoch > 0 or batch_index > cfg.queue_batch

        xp_b_all, x_b_all, xp_e_all, x_e_all = two_net_views(
            self.noisy, cfg.noise_fused, g, xp_l, x_l, xp_u, x_u)
        onehot = F.one_hot(lab_y, cfg.num_classes).float()

        logits_b_all, feat_b_all = net_b(xp_b_all, x_b_all, generator=g)
        logits_e_all, feat_e_all = net_e(xp_e_all, x_e_all, generator=g)
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
            # smoothing reads the queues before this step writes them
            probs, probs1 = probs_orig, probs_orig1
            if warm:
                probs = memory_smooth(xw.detach(), probs_orig, state.queue_w,
                                      cfg.alpha, cfg.temperature)
                probs1 = memory_smooth(xs.detach(), probs_orig1,
                                       state.queue_s, cfg.alpha,
                                       cfg.temperature)
            mask = (probs.max(dim=1).values >= adap_mask_thr).float()
            masks = (probs1.max(dim=1).values >= adap_mask_thr).float()
            # [other-net unlabeled feats, own labeled feats] with the
            # pre-smoothing probs / one-hot labels (train.py:223-237)
            queue_update(state.queue_w,
                         torch.cat([xw.detach(), feat_lab_b.detach()]),
                         torch.cat([probs_orig, onehot]))
            queue_update(state.queue_s,
                         torch.cat([xs.detach(), feat_lab_e.detach()]),
                         torch.cat([probs_orig1, onehot]))
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

        self._update(state, total_b + total_e, state.net_b.opt,
                     state.net_e.opt)

        with torch.no_grad():
            acc_e = (lab_e.argmax(dim=1) == lab_y).float().mean()
        return {"loss_contrast": contrast_b.detach(),
                "total_loss": total_b.detach(), "cls_loss": cls_b.detach(),
                "con_loss": con_b.detach(), "total_loss_e": total_e.detach(),
                "acc": acc_e, "mask_rate": mask.mean()}

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
