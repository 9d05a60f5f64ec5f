"""The paper-figure benchmarks of the port: twins of the JAX package's
``benchmarks/bench_{ussa,sssa,csa_models,resources,kernels}.py``, run by
section with ``python -m repro_torch.benchmarks.run``.

Figs. 8–10 and Table III are simulated CFU cycles and byte counts (host
numpy, no device); ``bench_kernels`` times the port's hand-written CUDA
kernels on the card and runs their plain versions on the CPU.
"""
