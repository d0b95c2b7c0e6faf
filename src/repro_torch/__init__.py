"""PyTorch / CUDA port of the nested mini-batch k-means package.

Mirrors `repro` module for module; imports `torch`, never `jax`, and
nothing of `repro`.
"""
