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

Gathers (``CMLPLConfig.gather_impl``): in "pool" mode, the default at the
reference schedule, the unique pixels of one call (a run, an epoch or a
step) are gathered once by CUDA kernel 1 (``ops/patch_gather.gather_pool``)
and every step takes its rows by position; "pallas" and "pallas_bf16"
launch a kernel twice a step; "xla" is the plain gather.  An "auto" whose
pool is over the budget takes "pallas" on the card and "xla" on the CPU.
Patches are inputs: nothing differentiates through a gather.

Random streams: the noise views and both dropout masks come from the
state's ``torch.Generator``, on the training device, in a fixed order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from cmlpl_tpu_torch.data.prep import PreparedScene
from cmlpl_tpu_torch.device import resolve_device
from cmlpl_tpu_torch.models.basenet import BaseNet2
from cmlpl_tpu_torch.objectives.cmlpl import (adaptive_threshold,
                                              graph_contrastive,
                                              pseudo_label_graph,
                                              soft_consistency)
from cmlpl_tpu_torch.objectives.queue import (memory_smooth, queue_init,
                                              queue_update)
from cmlpl_tpu_torch.objectives.supervised import cross_entropy
from cmlpl_tpu_torch.ops.noise import make_noiser, two_net_views
from cmlpl_tpu_torch.ops.patch_gather import (gather_pool,
                                              make_train_gather,
                                              poolify_batches,
                                              resolve_train_gather)
from cmlpl_tpu_torch.train.driver import EpochDriver, stack_schedule
from cmlpl_tpu_torch.train.state import CMLPLConfig, CMLPLTrainState, NetState
from cmlpl_tpu_torch.weights import (basenet2_state_dict_from_jax,
                                     init_basenet2_params)

#: metric keys of a step (``cmlpl_tpu/train/cmlpl.py:392-400``)
METRICS = ("loss_contrast", "total_loss", "cls_loss", "con_loss",
           "total_loss_e", "acc", "mask_rate")


def _not_ported(what: str, item: int, name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md section 1, item {item} "
        f"({name})")


class CMLPLTrainer(EpochDriver):
    """Builds the CMLPL state and runs its steps on ``device`` (the CUDA
    card unless the caller asks for the CPU)."""

    def __init__(self, config: CMLPLConfig, device=None):
        if config.extra_loss or config.augment or config.stack_nets:
            raise _not_ported("extra_loss, augment and stack_nets", 9,
                              "Extras")
        if config.compute_dtype != "float32":
            raise _not_ported(f"compute_dtype={config.compute_dtype!r} "
                              "training", 5, "bf16 training paths")
        # under f32 compute both input dtypes keep the inputs f32
        if config.input_dtype not in ("compute", "float32"):
            raise ValueError(f"unknown input_dtype {config.input_dtype!r}")
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

    # ------------------------------------------------------------------ #
    def _new_net(self, params) -> NetState:
        cfg = self.config
        model = BaseNet2(num_features=cfg.num_features, dropout=cfg.dropout,
                         num_classes=cfg.num_classes, n_pc=cfg.n_pc,
                         patch_size=cfg.patch_size,
                         compute_dtype=cfg.compute_dtype)
        model.load_state_dict(basenet2_state_dict_from_jax(params))
        model = model.to(self.device).train()
        # torch's Adam defaults are optax.adam's: b1 0.9, b2 0.999,
        # eps 1e-8 outside the square root, bias-corrected
        return NetState(model, torch.optim.Adam(model.parameters(),
                                                lr=cfg.lr))

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

    def init_state(self, seed) -> CMLPLTrainState:
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

    # ------------------------------------------------------------------ #
    def _step(self, state: CMLPLTrainState, xp_src, x_src, gather_xp,
              lab_idx, lab_y, unl_idx, adap_mask_thr: float,
              warm: bool) -> dict:
        cfg = self.config
        g = state.generator
        bt = lab_idx.shape[0]
        net_b, net_e = state.net_b.model, state.net_e.model

        xp_l = gather_xp(xp_src, lab_idx)
        x_l = x_src.index_select(0, lab_idx)
        xp_u = gather_xp(xp_src, unl_idx)
        x_u = x_src.index_select(0, unl_idx)
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

        state.net_b.opt.zero_grad(set_to_none=True)
        state.net_e.opt.zero_grad(set_to_none=True)
        (total_b + total_e).backward()
        state.net_b.opt.step()
        state.net_e.opt.step()
        state.step += 1

        with torch.no_grad():
            acc_e = (lab_e.argmax(dim=1) == lab_y).float().mean()
        return {"loss_contrast": contrast_b.detach(),
                "total_loss": total_b.detach(), "cls_loss": cls_b.detach(),
                "con_loss": con_b.detach(), "total_loss_e": total_e.detach(),
                "acc": acc_e, "mask_rate": mask.mean()}

    def _run(self, state, scene: PreparedScene, li, ly, ui, epochs,
             first_batch: int = 0):
        """Steps over (E, N, B) id arrays, epoch ``epochs[e]`` for row e;
        step i of a row has batch index ``first_batch + i``.  Returns
        (state, metrics stacked (E, N) on the device)."""
        cfg = self.config
        dev = self.device
        w, cols = cfg.patch_size, scene.cols
        if cfg.gather_impl == "pool":
            pool, li, ui = poolify_batches(li, ui)
            xp_src, x_src = gather_pool(
                scene.padded_pca, scene.spectra,
                torch.from_numpy(pool).to(dev), cols=cols, w=w)

            def gather_xp(src, pos):
                return src.index_select(0, pos)
        else:
            xp_src, x_src = self._prep_cube(scene.padded_pca), scene.spectra

            def gather_xp(src, ids):
                return self._gather(src, ids, cols, w)

        li, ui = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                  for a in (li, ui))
        ly = torch.from_numpy(np.asarray(ly, np.int64)).to(dev)
        rows = []
        for e, epoch in enumerate(epochs):
            thr = adaptive_threshold(epoch, cfg.num_epochs, cfg.thr)
            row = []
            for i in range(li.shape[1]):
                warm = epoch > 0 or first_batch + i > cfg.queue_batch
                row.append(self._step(state, xp_src, x_src, gather_xp,
                                      li[e, i], ly[e, i], ui[e, i], thr,
                                      warm))
            rows.append(row)
        return state, {k: torch.stack([torch.stack([m[k] for m in row])
                                       for row in rows])
                       for k in METRICS}

    # ------------------------------------------------------------------ #
    def train_step(self, state, scene: PreparedScene, lab_idx, lab_y,
                   unl_idx, epoch: int, batch_index: int):
        """One optimisation step.  ``epoch``/``batch_index`` drive the
        adaptive threshold (train.py:147-148) and the queue warm-up
        (train.py:212).  Returns (state, metrics of 0-d tensors)."""
        state, m = self._run(state, scene, np.asarray(lab_idx)[None, None],
                             np.asarray(lab_y)[None, None],
                             np.asarray(unl_idx)[None, None], [epoch],
                             first_batch=batch_index)
        return state, {k: v[0, 0] for k, v in m.items()}

    def train_epoch(self, state, scene: PreparedScene, lab_idx, lab_y,
                    unl_idx, epoch: int):
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
        cfg = self.config
        li, ly, ui = stack_schedule(sampler, cfg.num_epochs)
        return self._run(state, scene, li, ly, ui, range(cfg.num_epochs))

    def _format_log(self, epoch, batch_index, num_batches, m):
        cfg = self.config
        return (f"Epoch {epoch + 1}/{cfg.num_epochs}: "
                f"{batch_index + 1}/{num_batches} "
                f"loss_contrast={m['loss_contrast']:.2f} "
                f"total_loss={m['total_loss']:.4f} "
                f"cls_loss={m['cls_loss']:.4f} "
                f"con_loss={m['con_loss']:.4f} "
                f"acc={m['acc'] * 100:.2f}")
