"""Share of the traced train() call's loop seconds that the loop waited for a batch (train(stats=)'s prefetch_wait_seconds over loop_seconds)."""
from portbench import readers


def read(run):
    return readers.prefetch_wait_share(run)
