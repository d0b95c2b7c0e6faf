"""Seconds of a fit spent in its rounds, as the host loop clocks them
(the last telemetry record's ``t``; validation excluded)."""
from perfbench import readers


def read(run):
    return readers.unit_mean(run, "rounds_s")
