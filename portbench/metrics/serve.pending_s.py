"""Median seconds per request from its receipt by the server to the start of its execution (serve.pending span): job queue, prep and the wait for the exec stage."""
from portbench import spans


def read(run):
    return spans.median_per(run, "serve.pending", "request")
