"""Process start to the first timed unit: imports, the kernels' build or
load, the inputs made on the card, one warm-up unit."""


def read(run):
    return run.setup_s
