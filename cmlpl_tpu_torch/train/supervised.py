"""The supervised trainer of any zoo backbone (``cmlpl_tpu/train/
supervised.py``): cross-entropy over the labeled split, optional patch
augmentations, BatchNorm statistics updated in training mode, an optional
EMA teacher, and the full-scene map through the same ``ScenePredictor``.

A step gathers the batch's patches (kernel 1 each step on the card under
"auto", the plain gather on the CPU) and spectra, applies flip, rot90 and
radiation noise when ``augment`` is set, runs the model in training mode
(the BN running statistics update in its forward), takes the CE, one
``torch.optim.Adam`` step (optax's defaults are torch's) and then, with
``ema_alpha > 0``, the EMA of params and BN statistics from the updated
student (``:186-200``).  Random draws (augmentations, dropout masks) come
from the state's ``torch.Generator``, in that order.

The batches are ``_schedule``'s, a copy of the JAX trainer's (numpy
``default_rng(seed)``), so both packages train on the same batches.

Under a profiler (``utils/profiling.span``) ``new_state`` records
``train.new_state``, and ``train_run`` ``train.call`` with one
``train.step`` a step: ``train.gather``, ``train.forward``,
``train.backward`` and ``train.adam`` inside.

Over a ``mesh`` (``core/mesh.create_mesh``; the JAX trainer's GSPMD step
with the batch on "data", ``cmlpl_tpu/train/supervised.py:221-239``)
every rank gathers and augments the whole batch from its copy of the one
generator, the model runs on the rank's rows (``train/driver.Apply``:
its BatchNorms normalise by the global batch's statistics and its
dropouts draw the global batch's masks), the logits come back gathered,
so the loss, accuracy and history are global on every rank, and one
all-reduce sums the gradients before Adam.  The running statistics, the
Adam state and the EMA teacher stay replicated, bitwise.  The batch is
rounded to a multiple of the ranks (``schedule``).

On a ("data", "model") mesh (``core/mesh.create_mesh_2d``) the rows go
over the data axis (the BatchNorm sums, the gradients' all-reduce and
the batch's rounding too), and the zoo models with a ``feat_spe``
(``models/zoo.TP_MODELS``) hold the rank's shards of their spectral
path, their Adam moments and EMA teacher alike; the others, and every
``batch_stats``, are replicated over the model axis
(``cmlpl_tpu/train/supervised.py:112-130``).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from cmlpl_tpu_torch.core.mesh import (Mesh, all_reduce_grads, is_tp,
                                       place_state, tp_shard_tree)
from cmlpl_tpu_torch.data.augment import (radiation_noise, random_flip,
                                          random_rot90)
from cmlpl_tpu_torch.data.prep import PreparedScene
from cmlpl_tpu_torch.device import compute_precision, resolve_device
from cmlpl_tpu_torch.models.zoo import (TP_MODELS, ZOO, build_model,
                                        weight_ema)
from cmlpl_tpu_torch.objectives.supervised import cross_entropy
from cmlpl_tpu_torch.ops.patch_gather import (check_gather_mesh,
                                              make_train_gather,
                                              resolve_train_gather)
from cmlpl_tpu_torch.train.driver import Apply
from cmlpl_tpu_torch.utils.profiling import span
from cmlpl_tpu_torch.weights import (init_zoo_params, state_dict_from_jax,
                                     supervised_state_from_jax,
                                     supervised_state_to_jax)


@dataclasses.dataclass
class SupervisedState:
    """Mutable: a step updates the model (params and BN statistics), the
    Adam state and the EMA teacher in place and advances ``step``."""
    model: torch.nn.Module
    opt: torch.optim.Adam
    generator: torch.Generator   # augmentations and dropout masks
    step: int = 0
    # the EMA teacher (reference WeightEMA_BN, tools/models.py:155-164):
    # a copy of the model, params and BN statistics, when ema_alpha > 0
    ema: Optional[torch.nn.Module] = None


def _tensors(model: torch.nn.Module) -> dict:
    """Params and buffers (BN running statistics) by name."""
    return dict(model.named_parameters()) | dict(model.named_buffers())


def schedule(train_idx, labels, batch_size, num_epochs, epoch_samples,
             seed, data: int = 1):
    """Pre-draw every epoch's shuffled batches -> (T, B) arrays, as the
    JAX trainer's ``_schedule`` (``cmlpl_tpu/train/supervised.py:
    256-285``): the batch rounded down to a multiple of ``data`` (the
    ranks; at least ``data``), the split tiled when it is smaller (45
    labels on 2 ranks: batches of 44)."""
    rng = np.random.default_rng(seed)
    idx = np.asarray(train_idx)
    all_li, all_ly = [], []
    for _ in range(num_epochs):
        perm = rng.permutation(idx)
        if epoch_samples:
            reps = -(-epoch_samples // len(perm))
            perm = np.tile(perm, reps)[:epoch_samples]
        bs = min(batch_size, len(perm))
        bs = max((bs // data) * data, data)
        if len(perm) < bs:
            perm = np.tile(perm, -(-bs // len(perm)))[:bs]
        n_batches = max(len(perm) // bs, 1)
        for b in range(n_batches):
            li = perm[b * bs:(b + 1) * bs]
            if len(li) < bs:
                break
            all_li.append(li.astype(np.int32))
            all_ly.append((labels[li] - 1).astype(np.int32))
    return np.stack(all_li), np.stack(all_ly)


def steps_per_epoch(n_train: int, batch_size: int,
                    epoch_samples: Optional[int] = None,
                    data: int = 1) -> int:
    """Batches per epoch under :func:`schedule`'s rounding (for resume
    bookkeeping: epoch = state.step // steps_per_epoch)."""
    n = epoch_samples if epoch_samples else n_train
    bs = min(batch_size, n)
    bs = max((bs // data) * data, data)
    return max(max(n, bs) // bs, 1)


class SupervisedTrainer:
    """CE training of the zoo model ``name`` for the dataset ``spec`` on
    ``device`` (the CUDA card unless the caller asks for the CPU; default:
    the mesh's), data parallel over ``mesh`` (the module docstring).
    ``n_pc`` is resolved (all bands given as their count).  "pallas" and
    "pallas_bf16" asked for by name are refused over more than one rank,
    as in the JAX package."""

    def __init__(self, name: str, spec, *, lr: float = 5e-4,
                 patch_size: int, n_pc: int, augment: bool = False,
                 gather_impl: str = "auto", ema_alpha: float = 0.0,
                 device=None, mesh: Mesh | None = None):
        self.name = name.lower()
        self.entry = ZOO[self.name]
        self.spec = spec
        self.lr = lr
        self.patch_size = patch_size
        self.n_pc = n_pc
        self.augment = augment
        self.ema_alpha = float(ema_alpha)
        self.device = resolve_device(
            mesh.device if device is None and mesh is not None else device)
        self.mesh = mesh
        #: the mesh whose model axis splits the model, or None
        self.tp = mesh if is_tp(mesh) and self.name in TP_MODELS else None
        self.data = mesh.data_size if mesh is not None else 1
        check_gather_mesh(gather_impl, mesh)
        # a labeled-only epoch has no pre-gathered pool (the labeled set
        # is ~45 pixels): "auto" is the plain gather on the CPU, kernel 1
        # each step on the card, on every rank (each gathers its batch)
        self.gather_impl = resolve_train_gather(
            gather_impl, self.device, num_unlabel=0, patch_size=patch_size,
            n_pc=n_pc, pool_supported=False)
        self._prep_cube, self._gather = make_train_gather(self.gather_impl,
                                                          n_pc)

    # -- state ------------------------------------------------------------
    def new_state(self, params, batch_stats, run_seed: int
                  ) -> SupervisedState:
        """A state from the model's params and BN statistics in the JAX
        layout, a fresh Adam, the EMA teacher as a copy when
        ``ema_alpha > 0``, and a generator seeded with ``run_seed``."""
        with span("train.new_state"):
            model, _ = build_model(self.name, self.spec, self.n_pc,
                                   self.patch_size,
                                   **({"tp": self.tp} if self.tp else {}))
            model.load_state_dict(state_dict_from_jax(
                tp_shard_tree(params, self.tp),
                batch_stats=batch_stats or None))
            model = model.to(self.device).train()
            ema = (copy.deepcopy(model).eval() if self.ema_alpha > 0
                   else None)
            # torch's Adam defaults are optax.adam's: b1 0.9, b2 0.999,
            # eps 1e-8 outside the square root, bias-corrected
            return SupervisedState(
                model=model,
                opt=torch.optim.Adam(model.parameters(), lr=self.lr),
                generator=torch.Generator(self.device).manual_seed(run_seed),
                ema=ema)

    def init_state(self, seed) -> SupervisedState:
        """A fresh state from ``seed`` (an int or a sequence of ints, as
        ``numpy.random.SeedSequence`` takes): weights from the JAX model's
        initialisers' distributions (``weights.init_zoo_params``) and the
        run's generator; over a mesh, rank 0's on every rank
        (:meth:`place`)."""
        k_init, k_run = np.random.SeedSequence(seed).spawn(2)
        v = init_zoo_params(self.name, k_init, spec=self.spec,
                            n_pc=self.n_pc, patch_size=self.patch_size)
        return self.place(self.new_state(v["params"], v["batch_stats"],
                                         int(k_run.generate_state(1)[0])))

    def place(self, state: SupervisedState) -> SupervisedState:
        """``state`` as rank 0 holds it, on every rank of the mesh
        (``core/mesh.place_state``); the identity on one process."""
        return place_state(self.mesh, self, state)

    def state_to_jax(self, state: SupervisedState) -> dict:
        return supervised_state_to_jax(state)

    def state_from_jax(self, tree, run_seed: int = 0) -> SupervisedState:
        return supervised_state_from_jax(tree, self, run_seed)

    # -- model plumbing ---------------------------------------------------
    def _apply(self, model, xp, x, generator=None):
        """``model`` (a module, or any callable of its arguments) on the
        entry's inputs: the patch and spectrum, or the patch alone."""
        if self.entry.inputs == "dual":
            return model(xp, x, generator=generator)
        return model(xp, generator=generator)

    def logits_fn(self, model: torch.nn.Module):
        """``(xp, x) -> logits`` of ``model`` for ``ScenePredictor`` (a
        "patch" model ignores ``x``)."""
        def fn(xp, x):
            out = self._apply(model, xp, x)
            return out[0] if self.entry.returns_feature else out

        return fn

    def eval_model(self, state: SupervisedState, ema: bool = False):
        """The student (or, ``ema=True``, the EMA teacher) in eval mode:
        its BN layers use their running statistics.  Set the student back
        with ``.train()`` before training on."""
        if ema:
            if state.ema is None:
                raise ValueError("no EMA teacher in this state; construct "
                                 "the trainer with ema_alpha > 0")
            return state.ema.eval()
        return state.model.eval()

    def eval_variables(self, state: SupervisedState,
                       ema: bool = False) -> dict:
        """The inference variables as the JAX trainer returns them,
        ``{"params": ..., "batch_stats": ...}`` (the latter only for a
        model with BatchNorm), each by ``state_dict`` key."""
        sd = self.eval_model(state, ema).state_dict()
        stats = {k: v for k, v in sd.items()
                 if k.rsplit(".", 1)[-1] in ("running_mean", "running_var")}
        variables = {"params": {k: v for k, v in sd.items()
                                if k not in stats}}
        if stats:
            variables["batch_stats"] = stats
        return variables

    # -- steps --------------------------------------------------------------
    def _step(self, state: SupervisedState, xp, x, y) -> dict:
        g = state.generator
        if self.augment:
            xp = radiation_noise(g, random_rot90(g, random_flip(g, xp)))
        with span("train.forward"):
            apply = Apply(torch.nn.ModuleDict({"model": state.model}),
                          mesh=self.mesh)
            out = self._apply(functools.partial(apply, "model"), xp, x, g)
            logits = out[0] if self.entry.returns_feature else out
            loss = cross_entropy(logits, y)
        with span("train.backward"):
            state.opt.zero_grad(set_to_none=True)
            loss.backward()
            all_reduce_grads(state.model.parameters(), self.mesh)
        with span("train.adam"):
            state.opt.step()
        state.step += 1
        if state.ema is not None:
            weight_ema(_tensors(state.model), _tensors(state.ema),
                       self.ema_alpha)
        with torch.no_grad():
            acc = (logits.argmax(dim=1) == y).float().mean()
        return {"cls_loss": loss.detach(), "acc": acc}

    def train_run(self, state: SupervisedState, scene: PreparedScene,
                  lab_idx, lab_y):
        """Steps over stacked (T, B) pixel ids and labels; returns (state,
        metrics stacked (T,) on the device).  TF32 stays off: the zoo is
        f32."""
        with span("train.call"):
            dev = self.device
            cube = self._prep_cube(scene.padded_pca)
            li = torch.from_numpy(np.ascontiguousarray(lab_idx,
                                                       np.int32)).to(dev)
            ly = torch.from_numpy(np.asarray(lab_y, np.int64)).to(dev)
            state.model.train()
            rows = []
            with compute_precision("float32"):
                for i in range(li.shape[0]):
                    with span("train.step"):
                        with span("train.gather"):
                            ids = li[i]
                            xp = self._gather(cube, ids, scene.cols,
                                              self.patch_size).float()
                            x = scene.spectra.index_select(0, ids)
                        rows.append(self._step(state, xp, x, ly[i]))
            with span("train.metrics"):
                return state, {k: torch.stack([m[k] for m in rows])
                               for k in rows[0]}

    def train_step(self, state: SupervisedState, scene: PreparedScene,
                   lab_idx, lab_y):
        """One step on a (B,) batch; returns (state, 0-d metrics)."""
        state, m = self.train_run(state, scene, np.asarray(lab_idx)[None],
                                  np.asarray(lab_y)[None])
        return state, {k: v[0] for k, v in m.items()}

    # -- schedule (a copy of the JAX trainer's) ----------------------------
    def _schedule(self, train_idx, labels, batch_size, num_epochs,
                  epoch_samples, seed):
        """Pre-draw every epoch's shuffled batches -> (T, B) arrays, the
        batch a multiple of the ranks (:func:`schedule`)."""
        return schedule(train_idx, labels, batch_size, num_epochs,
                        epoch_samples, seed, self.data)

    def steps_per_epoch(self, n_train: int, batch_size: int,
                        epoch_samples: Optional[int] = None) -> int:
        """Batches per epoch under :meth:`_schedule`
        (:func:`steps_per_epoch`)."""
        return steps_per_epoch(n_train, batch_size, epoch_samples,
                               self.data)

    def fit(self, state: SupervisedState, scene: PreparedScene,
            train_idx: np.ndarray, labels: np.ndarray, *,
            batch_size: int = 128, num_epochs: int = 100,
            epoch_samples: Optional[int] = None, seed: int = 1088,
            log_every: int = 10, log_fn=print, start_epoch: int = 0,
            on_epoch_end=None):
        """Epoch driver over the labeled split (tiled to
        ``epoch_samples`` a epoch when given).  The whole schedule is one
        call, its metrics copied back once; with ``start_epoch`` (resume)
        or ``on_epoch_end(epoch, state)`` (checkpoints) one call an epoch.
        Returns (state, history: a dict of floats a step)."""
        li, ly = self._schedule(train_idx, labels, batch_size, num_epochs,
                                epoch_samples, seed)
        per_epoch = li.shape[0] // num_epochs
        history = []

        def log(epoch, m):
            log_fn(f"Epoch {epoch + 1}/{num_epochs} "
                   f"cls_loss={m['cls_loss']:.4f} "
                   f"acc={m['acc'] * 100:.2f}")

        def extend(stacked):
            stacked = {k: v.tolist() for k, v in stacked.items()}
            history.extend({k: v[i] for k, v in stacked.items()}
                           for i in range(len(stacked["cls_loss"])))

        if start_epoch == 0 and on_epoch_end is None:
            state, stacked = self.train_run(state, scene, li, ly)
            extend(stacked)
            if log_every:
                t = li.shape[0]
                for epoch in range(log_every - 1, num_epochs, log_every):
                    log(epoch, history[min((epoch + 1) * per_epoch, t) - 1])
            return state, history

        for epoch in range(start_epoch, num_epochs):
            sl = slice(epoch * per_epoch, (epoch + 1) * per_epoch)
            state, stacked = self.train_run(state, scene, li[sl], ly[sl])
            extend(stacked)
            if log_every and (epoch + 1) % log_every == 0:
                log(epoch, history[-1])
            if on_epoch_end is not None:
                on_epoch_end(epoch, state)
        return state, history
