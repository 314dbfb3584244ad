"""Median seconds per case of its file read and decode on a decode thread (infer.decode span) in the traced call."""
from portbench import spans


def read(run):
    return spans.median_per(run, "infer.decode", "case")
