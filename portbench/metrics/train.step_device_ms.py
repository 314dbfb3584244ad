"""Device busy milliseconds in the traced train() call (union of device intervals) per step it ran."""
from portbench import readers


def read(run):
    return readers.step_device_ms(run)
