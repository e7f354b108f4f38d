"""Set-up seconds: process start to the window's start (imports, kernels
loaded from the build directory, weights drawn on the device, the warm-up
that runs every shape the window runs)."""

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
