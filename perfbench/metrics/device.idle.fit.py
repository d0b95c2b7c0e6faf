"""Share of the profiled pass's window in which no operation ran on the
device (`readers.idle_percent`)."""
from perfbench import readers


def read(run):
    return readers.idle_percent(run)
