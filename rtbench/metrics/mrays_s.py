"""Every ray the window's frames traced (the program's exact count from
its live masks) over the window's seconds, in millions a second."""


def read(ctx):
    w = ctx["window"]
    return float(w.rays[:w.timed].sum()) / w.seconds / 1e6
