"""Median seconds per case of the write stage (the mask written as seg.nii.gz) in the traced call."""
from portbench import readers


def read(run):
    return readers.median_stage(run, "write")
