"""Median over the traced window's requests of the client's seconds less the server's own (the response's secs): waiting and transport."""
from portbench import readers


def read(run):
    return readers.median(run.get("queue_s"))
