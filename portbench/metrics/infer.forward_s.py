"""Median device seconds per case of the forward stage (sliding window, forward, blend, argmax; CUDA events)."""
from portbench import readers


def read(run):
    return readers.median_stage(run, "forward")
