"""Median seconds per request that its case loop waited at the end for the write-behind to write its masks (infer.drain span of the request)."""
from portbench import spans


def read(run):
    return spans.median_per(run, "infer.drain", "request")
