"""PyTorch/CUDA port of the sparse-DNN reproduction.

A second package beside the JAX reference ``repro``: the same pack
formats, models and streaming serving engine, with every Pallas TPU
kernel on the served path rewritten by hand for NVIDIA Hopper
(``csrc/*.cu``).  Module names follow the JAX package so each
counterpart is easy to find.  Nothing here imports ``jax`` or ``repro``.
"""
