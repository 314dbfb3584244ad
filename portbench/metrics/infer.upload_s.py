"""Median seconds per case of its upload on the upload thread: pinned copy, host-to-device copy, stream sync (infer.upload span) in the traced call."""
from portbench import spans


def read(run):
    return spans.median_per(run, "infer.upload", "case")
