"""Training state containers and the hyperparameter config
(``cmlpl_tpu/train/state.py``).  Defaults mirror the reference argparse
(``train.py:355-380``); the fields and defaults are the JAX package's."""

from __future__ import annotations

import dataclasses

import torch

from cmlpl_tpu_torch.models.basenet import BaseNet2
from cmlpl_tpu_torch.objectives.contrastive import MemoBankState
from cmlpl_tpu_torch.objectives.queue import QueueState


@dataclasses.dataclass(frozen=True)
class CMLPLConfig:
    num_classes: int = 9
    num_features: int = 103
    n_pc: int = 60
    patch_size: int = 20

    # labeled pixels drawn per class by the split recipe (train.py:357,
    # sample_generation.py:52-63); num_label * num_classes bounds the
    # labeled uniques a pre-gathered pool can contain
    num_label: int = 5

    labeled_batch: int = 128       # train.py:361
    unlabeled_batch: int = 128     # train.py:362
    val_batch: int = 512           # train.py:363
    lr: float = 5e-4               # train.py:365
    num_epochs: int = 20           # train.py:366
    num_unlabel: int = 10000       # train.py:368
    thr: float = 1.0               # train.py:369
    alpha: float = 0.95            # train.py:371
    queue_batch: int = 17          # train.py:372
    temperature: float = 0.3       # train.py:374
    dropout: float = 0.8           # train.py:377
    noise: float = 0.5             # train.py:378
    # loss weights (train.py:266, :270)
    w_contrast: float = 0.5
    w_consistency: float = 4.0
    feat_dim: int = 1024
    seed: int = 1088
    # "float32" | "bfloat16": the dtype of the models' convolutions and
    # dense layers (params, losses, queues and Adam stay f32)
    compute_dtype: str = "float32"
    # dtype of the gathered patches / spectra / noise views: "compute"
    # stores them in the compute dtype (under bf16 compute the pool is
    # gathered by kernel 2 and the views are drawn in bf16), "float32"
    # keeps them f32 (ops/patch_gather.make_input_cast)
    input_dtype: str = "compute"
    # accepted for the JAX package's CLI and configs, and without effect:
    # the eager trainers draw from Philox torch.Generators, an exported
    # training run from a threefry2x32 counter stream (core/rng.py)
    rng_impl: str = "threefry2x32"
    # noise views (ops/noise.py): "normal" | "binom16"; fused = 4 draws
    noise_impl: str = "normal"
    noise_fused: bool = False
    # training patch gather (ops/patch_gather.py):
    #   "auto"        "pool" when the pool fits POOL_AUTO_BUDGET_BYTES,
    #                 else "pallas" on the card and "xla" on the CPU
    #                 (resolved when the trainer is built)
    #   "pool"        gather the run's unique pixels once with kernel 1,
    #                 then take rows by position each step
    #   "xla"         the plain PyTorch gather each step
    #   "pallas"      kernel 1 (f32) each step, twice
    #   "pallas_bf16" kernel 2 (bf16 cube) each step, twice; patch inputs
    #                 bf16-quantised, everything else f32
    gather_impl: str = "auto"
    # CMLPL: both nets' forwards as ONE batched forward (torch.func.vmap
    # over the stacked params); the same math as two forwards, with the
    # dropout masks drawn in the same order.  A config field only, as in
    # the JAX package
    stack_nets: bool = False
    # CMLPL's opt-in extra objective, weighted by extra_weight: "" |
    # "memobank" (U2PL InfoNCE, net E teaches net B, a per-class bank of
    # memobank_size rows) | "mmd" (labeled/unlabeled feature MMD per net)
    # | "ntxent" (SimCLR across the two nets' views)
    extra_loss: str = ""
    extra_weight: float = 0.1
    memobank_size: int = 256
    # CMLPL's opt-in patch augmentations, any of "flip", "rot90",
    # "radiation", "mixture" (data/augment.py)
    augment: tuple = ()

    @property
    def queue_size(self) -> int:
        return 5 * self.labeled_batch * 2   # train.py:138


@dataclasses.dataclass
class NetState:
    model: BaseNet2
    opt: torch.optim.Adam


@dataclasses.dataclass
class CMLPLTrainState:
    """Mutable: a step updates the nets, the Adam states and the queues in
    place, replaces the bank and advances ``step``."""
    net_b: NetState          # "Base"  (train.py:118)
    net_e: NetState          # "Base1" (train.py:122)
    queue_w: QueueState      # smooths net E's probs (train.py:139-141)
    queue_s: QueueState      # smooths net B's probs (train.py:142-145)
    generator: torch.Generator   # every random draw of a step
    step: int = 0
    bank: MemoBankState | None = None   # extra_loss="memobank" only
