"""Kernel 4 (``ops.fused_round``): its bound over its CUDA-event time."""
from perfbench import readers


def read(run):
    return readers.roofline_percent(run, ("fused_round",))
