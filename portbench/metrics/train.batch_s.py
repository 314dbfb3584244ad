"""Median seconds per batch of its assembly on the prefetch thread: staging, crops, augmentation (train.batch span) in the traced train() call."""
from portbench import spans


def read(run):
    return spans.median_per(run, "train.batch", "id")
