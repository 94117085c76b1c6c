"""Seconds from the process's start to the window's: imports, CUDA
start-up, the kernel libraries loaded (built on a checkout's first run),
the scene made, the tables built and uploaded, the warm-up frames."""


def read(ctx):
    return float(ctx["setup_s"])
