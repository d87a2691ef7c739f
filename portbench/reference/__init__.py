"""Plain references of what the benchmark's cells compute, in PyTorch and
NumPy alone: the scene prep, the patch gather, BaseNet2 and a CMLPL step,
SSRN and a supervised step, and Adam.  They follow the published
descriptions (liuli33/CMLPL ``train.py``, ``tools/models.py``,
``tools/hyper_tools.py``, ``tools/conpared_models.py``) one model and one
seed at a time, with no kernel, batching over seeds or in-place state.
Nothing here imports the program, JAX or the harness.

Precision: every entry takes ``tf32``; False computes in float32 with
TF32 off for cuDNN and cuBLAS (what the configurations state), True lets
both use TF32 (the control, one step below).
"""
