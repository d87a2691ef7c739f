"""Closed-loop serving of a zoo model: ``serve_loop``'s traffic (one
client, a scene a request through the serve CLI in this process, each
map written as ``.npy``) with the configuration's ``model`` served by
``serve --model`` at its ``patch_size`` and ``n_pc``, from the
``{"params", "batch_stats"}`` tree that ``train_backbone --weights_out``
writes, and checked against the plain reference
``reference/<model>.py``.

The weights come from the seed, by the reference's names (the program's
``state_dict`` names): kernels uniform at LeCun's variance (bound
sqrt(3 / fan_in), as ``scenes.lecun_weights``), convolution and linear
biases uniform in +-1/sqrt(fan_in); BatchNorm scales and running
variances uniform in [0.5, 1.5), shifts and running means in [-0.5,
0.5); the attentions' ``gamma`` in [0.5, 1.5).  At their initial 0 the
attentions would add nothing, and a program that left them out would
pass; a trained model's are not 0.
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import torch

from portbench import scenes
from portbench.drivers import serve_loop, serving
from portbench.reference import prep as ref_prep
from portbench.reference.precision import matmul_precision

#: patches a forward of the reference's map
BLOCK = 1024


def reference(model: str):
    """The plain reference module of zoo model ``model``."""
    return importlib.import_module(f"portbench.reference.{model}")


def zoo_weights(stream, shapes: dict, device) -> dict:
    """One state dict of ``shapes`` drawn from ``stream`` on ``device``
    (the module docstring)."""
    g = torch.Generator(device).manual_seed(scenes.seed_int(stream))
    sd = {}
    for name, shape in shapes.items():
        u = torch.rand(shape, generator=g, device=device)
        layer, leaf = name.rsplit(".", 1)
        kernel = shapes.get(layer + ".weight", ())
        if len(shape) > 1:
            sd[name] = (2 * u - 1) * np.sqrt(3.0 / np.prod(shape[1:]))
        elif len(kernel) > 1:           # a convolution's or a linear bias
            sd[name] = (2 * u - 1) / np.sqrt(np.prod(kernel[1:]))
        elif leaf in ("bias", "running_mean"):
            sd[name] = u - 0.5
        else:              # a BatchNorm's scale or variance, or a gamma
            sd[name] = u + 0.5
    return sd


class Driver(serve_loop.Driver):
    def inputs(self) -> None:
        """``serve_loop``'s cubes and pick, and the zoo model's weights
        from the same stream as its weights."""
        super().inputs()
        p = self.p
        self.ref = reference(p["model"])
        self.weights = zoo_weights(
            scenes.streams(self.seed, 3)[0],
            self.ref.shapes(p["bands"], p["classes"]), self.device)

    def setup(self) -> None:
        from cmlpl_tpu_torch.weights import (save_params_npz,
                                             zoo_variables_to_jax)
        self.inputs()
        path = os.path.join(self.dir, "weights.npz")
        save_params_npz(path, zoo_variables_to_jax(
            self.p["model"], {k: v.cpu() for k, v in self.weights.items()}))
        serving.start(self, serving.argv(self.p, path, self.device))

    def _reference_logits(self, path: str, tf32: bool) -> torch.Tensor:
        p, dev = self.p, self.device
        padded, _ = ref_prep.prepare(np.load(path), p["n_pc"],
                                     p["patch_size"], dev)
        params = {k: v.to(dev) for k, v in self.weights.items()}
        with matmul_precision(tf32):
            return self.ref.scene_logits(params, padded, p["rows"],
                                         p["cols"], p["patch_size"], BLOCK)
