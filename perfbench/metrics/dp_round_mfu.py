"""The window's share of the card's TF32 peak: 2 rows k d operations of
the algorithm's own k-scanned rows over the window (`readers.mfu_percent`)."""
from perfbench import readers


def read(run):
    return readers.mfu_percent(run)
