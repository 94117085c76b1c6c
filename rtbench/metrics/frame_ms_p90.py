"""The 90th percentile over every frame of the window of one frame's
wait, from handing it its inputs to its image on the host, in ms."""

import numpy as np


def read(ctx):
    w = ctx["window"]
    return float(np.percentile(np.asarray(w.waits[:w.timed]) * 1e3, 90))
