"""Kernel 1 (``ops.assign_top2``): its bound over its CUDA-event time."""
from perfbench import readers


def read(run):
    return readers.roofline_percent(run, ("assign_top2",))
