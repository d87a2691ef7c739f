"""CPS trainer, Cross Pseudo Supervision (``cmlpl_tpu/train/cps.py``;
reference ``trian_CPS.py``).

The dual-BaseNet2 skeleton of CMLPL without the queues, the masks and the
contrastive graph: each net's unlabeled logits are supervised by the other
net's detached argmax with weight 0.1 (trian_CPS.py:238-249).  One
backward over ``total_b + total_e`` equals two because every cross term
reads a detached argmax; then both Adams step.

Random streams: the noise views and both dropout masks come from the
state's ``torch.Generator``, on the training device, in a fixed order.
"""

from __future__ import annotations

import dataclasses

import torch

from cmlpl_tpu_torch.objectives.cps import cps_cross_supervision
from cmlpl_tpu_torch.objectives.supervised import cross_entropy
from cmlpl_tpu_torch.train.driver import TwoNetDriver
from cmlpl_tpu_torch.train.state import NetState
from cmlpl_tpu_torch.weights import cps_state_from_jax, cps_state_to_jax


@dataclasses.dataclass
class CPSTrainState:
    """Mutable: a step updates the nets and the Adam states in place and
    advances ``step``."""
    net_b: NetState
    net_e: NetState
    generator: torch.Generator   # noise views and dropout masks
    step: int = 0


class CPSTrainer(TwoNetDriver):
    """Builds the CPS state and runs its steps on ``device`` (the CUDA card
    unless the caller asks for the CPU)."""

    CROSS_WEIGHT = 0.1  # trian_CPS.py:245, :248

    def new_state(self, params_b, params_e, run_seed: int) -> CPSTrainState:
        """A state from two BaseNet2 param trees in the JAX layout, fresh
        Adam states, and a generator seeded with ``run_seed``."""
        return CPSTrainState(
            net_b=self._new_net(params_b), net_e=self._new_net(params_e),
            generator=torch.Generator(self.device).manual_seed(run_seed))

    def state_to_jax(self, state: CPSTrainState) -> dict:
        return cps_state_to_jax(state)

    def state_from_jax(self, tree, run_seed: int = 0) -> CPSTrainState:
        return cps_state_from_jax(tree, self, run_seed)

    def _draws(self, g, xp_l, x_l, xp_u, x_u, lab_y) -> dict:
        return self._views(g, xp_l, x_l, xp_u, x_u)

    def _losses(self, apply, d, lab_y, carry, epoch, batch_index, g=None,
                thr=None):
        bt = lab_y.shape[0]
        (logits_b, _), (logits_e, _) = self._forwards(apply, d)
        lab_b, un_b = logits_b[:bt], logits_b[bt:]
        lab_e, un_e = logits_e[:bt], logits_e[bt:]
        cls_b = cross_entropy(lab_b, lab_y)
        cls_e = cross_entropy(lab_e, lab_y)
        cross_b = cps_cross_supervision(un_b, un_e)
        cross_e = cps_cross_supervision(un_e, un_b)
        total_b = cls_b + self.CROSS_WEIGHT * cross_b
        total_e = cls_e + self.CROSS_WEIGHT * cross_e
        with torch.no_grad():
            acc_e = (lab_e.argmax(dim=1) == lab_y).float().mean()
        return total_b + total_e, {
            "total_loss": total_b.detach(), "cls_loss": cls_b.detach(),
            "con_loss": cross_b.detach(), "acc": acc_e}, {}

    def _format_log(self, epoch, batch_index, num_batches, m):
        return (f"Epoch {epoch + 1}/{self.config.num_epochs}: "
                f"{batch_index + 1}/{num_batches} "
                f"total_loss={m['total_loss']:.4f} "
                f"cls_loss={m['cls_loss']:.4f} "
                f"con_loss={m['con_loss']:.4f} "
                f"acc={m['acc'] * 100:.2f}")
