"""All kernel calls of one fit and predict: the sum of their bounds over
the sum of their CUDA-event times."""
from perfbench import readers


def read(run):
    return readers.roofline_percent(run)
