"""Fused multi-seed CMLPL training: ``seeds`` runs as one step loop over
a ``SeedStack``, each call of ``EpochDriver._run`` one epoch of every
seed's schedule (its own pool gather, then the steps), as
``train_multi_run`` and the CLI's epoch hook drive it.

Set-up makes the scene, the splits, every seed's schedule (``num_epochs``
epochs), both networks' weights for every seed and the seeds' generator
seeds, builds the trainer and the stacked states, and drives them through
the first ``checked_steps`` batches of epoch 1 in two calls (the first
step alone, so that its gradients can be read from Adam's state).  The
window runs epochs 2, 3, ... of the same object, one call an epoch, until
``--seconds`` have passed; each call ends when its metrics reach the
host.  The check follows the checked steps of every seed with the plain
reference.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import compare, counts, scenes
from portbench.drivers import common
from portbench.reference import basenet2 as ref_net
from portbench.reference import cmlpl as ref_cmlpl

#: Adam's b1: after one step the first moment is (1 - b1) times the
#: gradient
B1 = 0.9


class Driver:
    def __init__(self, cell, seed: int, device):
        self.p = cell.params
        self.seed = seed
        self.device = torch.device(device)

    # -- inputs made from the seed ---------------------------------------
    def inputs(self) -> None:
        p, dev = self.p, self.device
        s = self.seeds = p["seeds"]
        st = scenes.streams(self.seed, 5)
        self.cube, self.gt = common.scene(st[0], p, dev)
        train, unl = scenes.make_splits(st[1], self.gt, p["num_label"],
                                        p["num_unlabel"])
        sched = [scenes.semi_epochs(
            q, train, unl, self.gt, epochs=p["num_epochs"],
            labeled_batch=p["labeled_batch"],
            unlabeled_batch=p["unlabeled_batch"],
            num_unlabel=p["num_unlabel"]) for q in st[2].spawn(s)]
        self.li, self.ly, self.ui = (np.stack([x[j] for x in sched])
                                     for j in range(3))   # (S, E, N, B)
        shapes = ref_net.shapes(p["n_pc"], p["bands"], p["classes"],
                                p["patch_size"])
        sds = scenes.basenet2_weights(st[3], shapes, 2 * s, dev)
        self.w_b, self.w_e = sds[0::2], sds[1::2]
        self.run_seeds = [scenes.seed_int(q) for q in st[4].spawn(s)]
        self.checked = [(self.li[i, 1, :p["checked_steps"]],
                         self.ly[i, 1, :p["checked_steps"]],
                         self.ui[i, 1, :p["checked_steps"]])
                        for i in range(s)]

    # -- the program -------------------------------------------------------
    def setup(self) -> None:
        from cmlpl_tpu_torch.train.cmlpl import CMLPLTrainer
        from cmlpl_tpu_torch.train.state import CMLPLConfig
        from cmlpl_tpu_torch.weights import params_to_jax

        self.inputs()
        p, dev = self.p, self.device
        self.scene = common.prepared(p, self.cube, self.gt, p["n_pc"], dev)
        cfg = CMLPLConfig(
            num_classes=p["classes"], num_features=p["bands"], n_pc=p["n_pc"],
            patch_size=p["patch_size"], num_label=p["num_label"],
            labeled_batch=p["labeled_batch"],
            unlabeled_batch=p["unlabeled_batch"], lr=p["lr"],
            num_epochs=p["num_epochs"], num_unlabel=p["num_unlabel"],
            thr=p["thr"], alpha=p["alpha"], queue_batch=p["queue_batch"],
            temperature=p["temperature"], dropout=p["dropout"],
            noise=p["noise"], w_contrast=p["w_contrast"],
            w_consistency=p["w_consistency"], feat_dim=p["feat_dim"],
            compute_dtype=p["precision"])
        self.trainer = tr = CMLPLTrainer(cfg, device=dev)

        def tree(sd):
            return params_to_jax({k: v.cpu() for k, v in sd.items()})

        self.ms = tr.stack_states([
            tr.new_state(tree(b), tree(e), r)
            for b, e, r in zip(self.w_b, self.w_e, self.run_seeds)])
        k = p["checked_steps"]
        m1 = self._call(1, 0, 1)
        opts = {id(o_p): o for o in self.ms.opts for o_p in
                (q for g in o.param_groups for q in g["params"])}
        self.grads = {}
        for name, leaf in self.ms.params.items():
            st = opts[id(leaf)].state.get(leaf)
            self.grads[name] = (st["exp_avg"] / (1 - B1) if st else
                                torch.zeros_like(leaf)).detach().clone()
        m2 = self._call(1, 1, k)
        # (S, k) losses of each net, then each seed's flat (B, E) pairs
        tb, te = (np.concatenate([m1[key], m2[key]], -1)[:, 0]
                  for key in ("total_loss", "total_loss_e"))
        self.losses = np.stack([tb, te], -1).reshape(self.seeds, -1)
        self.after = {n: v.detach().clone() for n, v in self.ms.params.items()}
        rows = k * (p["labeled_batch"] + p["unlabeled_batch"])
        self.queues = {n: (self.ms.carry["queue_" + n].feats[:, :rows].clone(),
                           self.ms.carry["queue_" + n].probs[:, :rows].clone())
                       for n in ("w", "s")}
        self.epoch = 2

    def _call(self, epoch: int, lo: int, hi: int) -> dict:
        """One call of the trainer over batches lo:hi of ``epoch``; returns
        its metrics on the host, so the call has ended."""
        sl = (slice(None), slice(epoch, epoch + 1), slice(lo, hi))
        _, m = self.trainer._run(self.ms, self.scene, self.li[sl],
                                 self.ly[sl], self.ui[sl], [epoch],
                                 first_batch=lo)
        return {k: v.cpu().numpy() for k, v in m.items()}

    def window(self, seconds: float, prof) -> dict:
        p = self.p
        n = self.li.shape[2]
        steps = 0
        t0 = time.perf_counter()
        while True:
            with common.span(prof, "epoch call (_run: pool gather, steps)"):
                self._call(self.epoch, 0, n)
            steps += n
            self.epoch = 2 + (self.epoch - 1) % (p["num_epochs"] - 2)
            if time.perf_counter() - t0 >= seconds:
                break
        dt = time.perf_counter() - t0
        if prof is not None:
            prof.mark_end()
        seed_steps = steps * self.seeds
        return {"seconds": dt, "attempted": seed_steps, "failed": 0,
                "samples": seed_steps * (p["labeled_batch"]
                                         + p["unlabeled_batch"]),
                "flops": seed_steps * counts.cmlpl_step_flops(p, warm=True)}

    def release(self) -> None:
        del self.ms, self.trainer, self.scene
        gc.collect()

    # -- the check ---------------------------------------------------------
    def _reference(self, padded, spectra, i: int, tf32: bool) -> dict:
        steps = [(li, ly, ui, 1, j) for j, (li, ly, ui) in
                 enumerate(zip(*self.checked[i]))]
        return ref_cmlpl.run(self.p, self.w_b[i], self.w_e[i],
                             self.run_seeds[i], padded, spectra,
                             self.p["cols"], steps, tf32=tf32)

    def _initial(self, i: int) -> dict:
        return {**{f"net_b.{k}": v for k, v in self.w_b[i].items()},
                **{f"net_e.{k}": v for k, v in self.w_e[i].items()}}

    def _numbers(self, got: dict, ref: dict, i: int) -> dict:
        """The compared numbers of seed ``i``: ``got`` holds the losses
        (flat), first gradients, params after and queues of the side
        judged."""
        w0 = self._initial(i)
        out = common.training_checks(
            got["losses"], [v for pair in ref["losses"] for v in pair],
            got["grads"], ref["grads"], compare.change(got["params"], w0),
            compare.change(ref["params"], w0))
        out["queue_gap"] = max(
            float((a - b[:len(a)]).abs().max()) for n in ("w", "s")
            for a, b in zip(got["queues"][n], ref["queues"][n]))
        return out

    def check(self) -> dict:
        padded, spectra = common.reference_scene(
            self.cube, self.p["n_pc"], self.p["patch_size"], self.device)
        per_seed = []
        for i in range(self.seeds):
            got = {"losses": [float(v) for v in self.losses[i]],
                   "grads": {n: v[i] for n, v in self.grads.items()},
                   "params": {n: v[i] for n, v in self.after.items()},
                   "queues": {n: (f[i], q[i]) for n, (f, q) in
                              self.queues.items()}}
            per_seed.append(self._numbers(
                got, self._reference(padded, spectra, i, False), i))
        return common.worst(per_seed)

    def control(self) -> dict:
        """The numbers of the reference in TF32 judged against the
        reference in float32 (no program runs; :meth:`inputs` first)."""
        padded, spectra = common.reference_scene(
            self.cube, self.p["n_pc"], self.p["patch_size"], self.device)
        per_seed = []
        for i in range(self.seeds):
            low = self._reference(padded, spectra, i, True)
            got = {"losses": [v for pair in low["losses"] for v in pair],
                   "grads": low["grads"], "params": low["params"],
                   "queues": low["queues"]}
            per_seed.append(self._numbers(
                got, self._reference(padded, spectra, i, False), i))
        return common.worst(per_seed)
