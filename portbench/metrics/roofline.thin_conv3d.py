"""Least seconds of every thin_conv3d launch over its kernels' seconds in the device trace."""
from portbench import readers


def read(run):
    return readers.thin_conv_roofline(run)
