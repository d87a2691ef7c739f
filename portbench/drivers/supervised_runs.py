"""Supervised runs back to back: each run a fresh state of the zoo model
``model`` trained by ``SupervisedTrainer.train_run`` over
``num_epochs`` one-batch epochs, as a user training baselines runs
them one after another.

Set-up makes the scene, the labeled split, ``prepared_runs`` runs'
schedules, weights and generator seeds (the window cycles through them),
builds the trainer, the first run's state, and drives that state through
its first ``checked_steps`` steps in two calls (the first step alone, so
that its gradients can be read from Adam's state).  The window finishes
that run and then starts and trains one run after another, each state's
building inside the window, until ``--seconds`` have passed; each run
ends when its metrics reach the host.  The check follows the checked
steps with the plain reference.
"""

from __future__ import annotations

import gc
import time

import torch

from portbench import compare, counts, scenes
from portbench.drivers import common
from portbench.reference import ssrn as ref_ssrn

B1 = 0.9


class Driver:
    def __init__(self, cell, seed: int, device):
        self.p = cell.params
        self.seed = seed
        self.device = torch.device(device)
        if self.p["model"] != "ssrn":
            raise ValueError(f"no plain reference of {self.p['model']!r}")

    def inputs(self) -> None:
        p, dev = self.p, self.device
        st = scenes.streams(self.seed, 5)
        self.cube, self.gt = common.scene(st[0], p, dev)
        train, _ = scenes.make_splits(st[1], self.gt, p["num_label"], 0)
        self.runs = [scenes.supervised_steps(q, train, self.gt,
                                             steps=p["num_epochs"],
                                             batch=p["batch"])
                     for q in st[2].spawn(p["prepared_runs"])]
        self.weights = scenes.lecun_weights(
            st[3], ref_ssrn.shapes(p["bands"], p["classes"]),
            p["prepared_runs"], dev)
        self.run_seeds = [scenes.seed_int(q)
                          for q in st[4].spawn(p["prepared_runs"])]
        k = p["checked_steps"]
        self.checked = list(zip(self.runs[0][0][:k], self.runs[0][1][:k]))

    def setup(self) -> None:
        from cmlpl_tpu_torch.registry import get_dataset
        from cmlpl_tpu_torch.train.supervised import SupervisedTrainer
        from cmlpl_tpu_torch.weights import zoo_variables_to_jax

        self.inputs()
        p, dev = self.p, self.device
        self.scene = common.prepared(p, self.cube, self.gt, p["bands"], dev)
        self.trainer = SupervisedTrainer(
            p["model"], get_dataset(p["dataset_id"]), lr=p["lr"],
            patch_size=p["patch_size"], n_pc=p["bands"], device=dev)
        self.trees = [zoo_variables_to_jax(
            p["model"], {k: v.cpu() for k, v in sd.items()})
            for sd in self.weights]
        self.state = self._state(0)
        k = p["checked_steps"]
        li, ly = self.runs[0]
        m1 = self._train(self.state, li[:1], ly[:1])
        self.grads = {}
        for name, leaf in self.state.model.named_parameters():
            st = self.state.opt.state.get(leaf)
            self.grads[name] = (st["exp_avg"] / (1 - B1) if st else
                                torch.zeros_like(leaf)).detach().clone()
        m2 = self._train(self.state, li[1:k], ly[1:k])
        self.losses = list(m1) + list(m2)
        self.after = {n: v.detach().clone()
                      for n, v in self.state.model.named_parameters()}

    def _state(self, run: int):
        tree = self.trees[run % len(self.trees)]
        return self.trainer.new_state(tree["params"], tree["batch_stats"],
                                      self.run_seeds[run % len(self.trees)])

    def _train(self, state, li, ly) -> list:
        """Steps of ``state`` over (T, B) ids and classes; the losses on
        the host, so the call has ended."""
        _, m = self.trainer.train_run(state, self.scene, li, ly)
        return m["cls_loss"].cpu().tolist()

    def window(self, seconds: float, prof) -> dict:
        p = self.p
        k = p["checked_steps"]
        li, ly = self.runs[0]
        t0 = time.perf_counter()
        with common.span(prof, "train_run"):
            self._train(self.state, li[k:], ly[k:])
        steps, run = len(li) - k, 1
        self.state = None
        while time.perf_counter() - t0 < seconds:
            li, ly = self.runs[run % len(self.runs)]
            with common.span(prof, "run start (new_state)"):
                state = self._state(run)
            with common.span(prof, "train_run"):
                self._train(state, li, ly)
            steps += len(li)
            run += 1
        dt = time.perf_counter() - t0
        if prof is not None:
            prof.mark_end()
        return {"seconds": dt, "attempted": steps, "failed": 0,
                "samples": steps * p["batch"],
                "flops": steps * counts.supervised_step_flops(p)}

    def release(self) -> None:
        self.state = self.trainer = self.scene = None
        gc.collect()

    def _reference(self, tf32: bool) -> dict:
        padded, _ = common.reference_scene(self.cube, self.p["bands"],
                                           self.p["patch_size"], self.device)
        return ref_ssrn.run(self.p, self.weights[0], padded, self.p["cols"],
                            self.checked, tf32=tf32)

    def _numbers(self, got: dict, ref: dict) -> dict:
        w0 = {k: v for k, v in self.weights[0].items() if k in ref["params"]}
        return common.training_checks(
            got["losses"], ref["losses"], got["grads"], ref["grads"],
            compare.change(got["params"], w0),
            compare.change(ref["params"], w0))

    def check(self) -> dict:
        return common.worst([self._numbers(
            {"losses": self.losses, "grads": self.grads,
             "params": self.after}, self._reference(False))])

    def control(self) -> dict:
        """The reference in TF32 judged against the reference in float32
        (no program runs; :meth:`inputs` first)."""
        return common.worst([self._numbers(self._reference(True),
                                           self._reference(False))])
