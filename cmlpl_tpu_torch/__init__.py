"""PyTorch/CUDA port of cmlpl_tpu: semi-supervised hyperspectral
classification on an NVIDIA Hopper card.

The JAX package ``cmlpl_tpu`` is the reference this package is held
against; nothing here imports it or JAX.
"""
