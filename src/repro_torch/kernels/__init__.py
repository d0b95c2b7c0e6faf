"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), their
ctypes wrappers, their plain PyTorch versions (`ref`) and the dispatch
(`plan`, `ops`)."""
