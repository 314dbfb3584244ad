"""Useful operations of the cases written (boxes times one forward's convolutions) over the traced call's seconds and the bf16 peak."""
from portbench import readers


def read(run):
    return readers.mfu(run, readers.infer_flops(run))
