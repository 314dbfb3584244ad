"""Share of the traced train() call in which no kernel, copy or set ran on the card (union of device intervals)."""
from portbench import readers


def read(run):
    return readers.idle_share(run)
