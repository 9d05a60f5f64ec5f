"""The benchmarks of the port: twins of the JAX package's
``benchmarks/bench_{ussa,sssa,csa_models,resources,kernels,int7,serving}.py``,
run by section with ``python -m repro_torch.benchmarks.run``.

Figs. 8–10 and Table III are simulated CFU cycles and byte counts (host
numpy, no device); ``bench_kernels`` times the port's hand-written CUDA
kernels on the card and runs their plain versions on the CPU;
``bench_int7`` (Table II) trains three CNNs and ``bench_serving`` serves
its request mixes through the ``Engine``, on the card or the CPU.
"""
