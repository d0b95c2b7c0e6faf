"""Milliseconds a data-parallel round: the window over the rounds in it."""


def read(run):
    return 1e3 * run.window_s / len(run.units) if run.units else None
