"""CCT trainer, Cross-Consistency Training (``cmlpl_tpu/train/cct.py``;
reference ``trian_CCT.py``).

One ``CCTNet`` encoder and three linear heads (trian_CCT.py:143-151).  The
unlabeled features get two Gaussian feature-space perturbations
(trian_CCT.py:205-206), and a 4-way symmetric JS consistency ties the
perturbed heads to the clean head (trian_CCT.py:211-215).

The reference takes one backward and then steps *two* Adams whose
parameter sets overlap in the encoder (trian_CCT.py:161-162, :221-223):
the encoder takes two Adam updates from the same gradients, each with its
own moments.  Here ``opt_base`` (encoder, ``dec_base``) steps before
``opt_aug`` (encoder, ``dec1``, ``dec2``), the order in which the JAX
package adds the two updates.  Since Adam's update reads only the gradient
and its own moments, not the weights, the second step is the JAX one.

Random streams: the input and feature noise come from the state's
``torch.Generator``, in the JAX package's order.  The encoder applies no
dropout, so nothing else is drawn.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from cmlpl_tpu_torch.models.basenet import CCTNet, LinearClassifier, joint_dim
from cmlpl_tpu_torch.objectives.cct import softmax_js_loss
from cmlpl_tpu_torch.objectives.supervised import cross_entropy
from cmlpl_tpu_torch.train.driver import EpochDriver
from cmlpl_tpu_torch.weights import (cct_state_from_jax, cct_state_to_jax,
                                     init_cct_params, state_dict_from_jax)

HEADS = ("dec_base", "dec1", "dec2")


@dataclasses.dataclass
class CCTTrainState:
    """Mutable: a step updates the model and both Adam states in place and
    advances ``step``."""
    model: nn.ModuleDict            # "encoder" and the three HEADS
    opt_base: torch.optim.Adam      # over (encoder, dec_base)
    opt_aug: torch.optim.Adam       # over (encoder, dec1, dec2)
    generator: torch.Generator      # input and feature noise
    step: int = 0


def cct_logits_fn(model: nn.ModuleDict):
    """``(xp, x) -> logits`` of the CCT map: the encoder's joint feature
    through the ``dec_base`` head (trian_CCT.py:246, hyper_tools.py:462-484)."""
    return lambda xp, x: model["dec_base"](model["encoder"](xp, x)[0])


class CCTTrainer(EpochDriver):
    """Builds the CCT state and runs its steps on ``device`` (the CUDA card
    unless the caller asks for the CPU)."""

    #: the JAX state tree's places (``train/functional.StateLayout``): the
    #: two Adams overlap in the encoder, ``opt_base`` stepping first
    JAX_PARAMS = {"model": ("params",)}
    JAX_OPTS = (("model", ("opt_base", "0")), ("model", ("opt_aug", "0")))

    def new_state(self, params, run_seed: int) -> CCTTrainState:
        """A state from the CCT param tree in the JAX layout
        (``{"encoder", "dec_base", "dec1", "dec2"}``), fresh Adam states,
        and a generator seeded with ``run_seed``."""
        cfg = self.config
        model = nn.ModuleDict({"encoder": CCTNet(
            num_features=cfg.num_features, dropout=cfg.dropout,
            num_classes=cfg.num_classes, n_pc=cfg.n_pc,
            patch_size=cfg.patch_size, compute_dtype=cfg.compute_dtype)})
        for name in HEADS:
            model[name] = LinearClassifier(
                cfg.num_classes, in_features=joint_dim(cfg.patch_size))
        model.load_state_dict(state_dict_from_jax(params))
        model = model.to(self.device).train()
        enc = list(model["encoder"].parameters())

        def adam(*heads):
            return torch.optim.Adam(
                enc + [p for h in heads for p in model[h].parameters()],
                lr=cfg.lr)

        return CCTTrainState(
            model=model, opt_base=adam("dec_base"),
            opt_aug=adam("dec1", "dec2"),
            generator=torch.Generator(self.device).manual_seed(run_seed))

    def init_state(self, seed) -> CCTTrainState:
        """A fresh state from ``seed`` (as ``numpy.random.SeedSequence``
        takes): the CCT params with torch-default init bounds, and the
        run's generator."""
        cfg = self.config
        k_params, k_run = np.random.SeedSequence(seed).spawn(2)
        return self.new_state(
            init_cct_params(k_params, n_pc=cfg.n_pc,
                            num_features=cfg.num_features,
                            num_classes=cfg.num_classes,
                            patch_size=cfg.patch_size),
            int(k_run.generate_state(1)[0]))

    def state_to_jax(self, state: CCTTrainState) -> dict:
        return cct_state_to_jax(state)

    def state_from_jax(self, tree, run_seed: int = 0) -> CCTTrainState:
        return cct_state_from_jax(tree, self, run_seed)

    def _modules(self, state: CCTTrainState) -> dict:
        return {"model": state.model}

    def _opts(self, state: CCTTrainState) -> tuple:
        return state.opt_base, state.opt_aug

    def _draws(self, g, xp_l, x_l, xp_u, x_u, lab_y) -> dict:
        """The noisy labeled and unlabeled inputs (trian_CCT.py:179-197),
        then the two feature-space perturbations of the unlabeled
        features (trian_CCT.py:205-206), drawn here and added in
        ``_losses``."""
        noisy = self.noisy
        if self.config.noise_fused:
            xp_all = noisy(g, torch.cat([xp_l, xp_u]))
            x_all = noisy(g, torch.cat([x_l, x_u]))
        else:
            xp_all = torch.cat([noisy(g, xp_l), noisy(g, xp_u)])
            x_all = torch.cat([noisy(g, x_l), noisy(g, x_u)])
        # the encoder's joint feature is f32
        shape = (xp_u.shape[0], joint_dim(self.config.patch_size))
        aug1, aug2 = (noisy.sample(g, shape, torch.float32, xp_u.device)
                      for _ in range(2))
        return {"xp": xp_all, "x": x_all, "aug1": aug1, "aug2": aug2}

    def _losses(self, apply, d, lab_y, carry, epoch, batch_index, thr=None):
        bt = lab_y.shape[0]
        scale = self.noisy.scale
        fea_all, _ = apply("model.encoder", d["xp"], d["x"])
        fea_lab, fea_un = fea_all[:bt], fea_all[bt:]
        lab_out = apply("model.dec_base", fea_lab)
        cls = cross_entropy(lab_out, lab_y)

        fea_aug1 = fea_un + d["aug1"] * scale
        fea_aug2 = fea_un + d["aug2"] * scale
        origin_out = apply("model.dec_base", fea_un)
        aug_out1 = apply("model.dec1", fea_aug1)
        aug_out2 = apply("model.dec2", fea_aug2)
        ori_t = torch.softmax(origin_out.detach(), dim=1)
        t1 = torch.softmax(aug_out1.detach(), dim=1)
        t2 = torch.softmax(aug_out2.detach(), dim=1)
        total = (cls
                 + softmax_js_loss(origin_out, t1)
                 + softmax_js_loss(origin_out, t2)
                 + softmax_js_loss(aug_out1, ori_t)
                 + softmax_js_loss(aug_out2, ori_t))
        with torch.no_grad():
            acc = (lab_out.argmax(dim=1) == lab_y).float().mean()
        return total, {"total_loss": total.detach(), "cls_loss": cls.detach(),
                       "acc": acc}, {}

    def _format_log(self, epoch, batch_index, num_batches, m):
        return (f"Epoch {epoch + 1}/{self.config.num_epochs}: "
                f"{batch_index + 1}/{num_batches} "
                f"total_loss={m['total_loss']:.4f} "
                f"cls_loss={m['cls_loss']:.4f} "
                f"acc={m['acc'] * 100:.2f}")
