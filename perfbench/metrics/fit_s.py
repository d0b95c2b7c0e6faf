"""Seconds a fit-and-predict unit: the window over the units in it."""


def read(run):
    return run.window_s / len(run.units) if run.units else None
