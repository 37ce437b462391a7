"""The port's benchmarks: the counterparts of the JAX package's
``benchmarks/`` modules under the same module, function and flag names
(``engine_real``, ``prefix_cache``, ``engine_sharded``, ``bench_trend``, the
paper figures, ``kernels``, ``run``).  Each imports torch, numpy and
``repro_torch`` only and writes its JSON under ``build/``."""
