"""The benchmark of the PyTorch and CUDA port, ``repro_torch``: one cell a
run (``perfbench/run.py``), driven by ``BENCHMARK.json``."""
