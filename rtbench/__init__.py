"""The benchmark of raytracing_tpu_torch, the PyTorch and CUDA port: one
cell a run (``python3 -m rtbench.run``), cells, configurations, traffic
mixes and per-layer metrics found by name from ``BENCHMARK.json``."""
