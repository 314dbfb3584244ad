"""Megabytes uploaded per step for crops whose case the data stage's device cache did not hold (counter train.stage_bytes over the train.step spans)."""
from portbench import spans


def read(run):
    per = spans.per_span(run, "train.stage_bytes", "train.step")
    return None if per is None else per / 1e6
