"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), their
plain PyTorch versions (``ref``) and the dispatch layer."""
