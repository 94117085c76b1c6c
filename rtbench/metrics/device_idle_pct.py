"""The share of a frame's time in which no device operation (kernel,
copy, fill) runs, in %: the union of the device operations' intervals in
the traced frames, a frame, over the mean length of the window's frames
that were not traced (the profiler's own cost on the host stretches the
frames it records, and would read as idle device time)."""


def read(ctx):
    lay = ctx["layer"]
    if not lay["trace"].ops or not lay["unprofiled_frames"]:
        return None
    frame_s = lay["unprofiled_s"] / lay["unprofiled_frames"]
    return 100.0 * (1.0 - lay["busy_per_frame"] / frame_s)
