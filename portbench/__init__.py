"""portbench: the benchmark of the PyTorch/CUDA port, dss_tpu_torch.

Run one cell with `python3 -m portbench.run` (see portbench/run.py).
It imports nothing of the JAX package, of jax, of `benchmarks/`, of
`bench.py` or of `chip_smoke.py`; its reference (portbench/reference/)
imports nothing of the port either.
"""
