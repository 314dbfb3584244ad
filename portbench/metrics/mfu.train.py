"""Useful operations of the traced call's steps (3 x batch x one forward's convolutions; remat's recompute not counted) over its seconds and the bf16 peak."""
from portbench import readers


def read(run):
    return readers.mfu(run, run.get("steps", 0) * run.get("step_flops", 0))
