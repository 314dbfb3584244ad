"""Median seconds per case of the read stage (file read, decode, upload) in the traced call."""
from portbench import readers


def read(run):
    return readers.median_stage(run, "read")
