"""Useful operations of the requests answered in the traced window (boxes times one forward's convolutions) over its seconds and the bf16 peak."""
from portbench import readers


def read(run):
    return readers.mfu(run, readers.infer_flops(run))
