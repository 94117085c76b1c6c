"""Device operations (kernels, copies, fills) in the traced frames, a
frame.  The harness holds the profiler's count of the hand-written
kernels to the program's own count (``kernels.LAUNCHES``) and profiles
again when it falls short; the standard error says whether it matched."""

from rtbench import trace as tr


def read(ctx):
    lay = ctx["layer"]
    ops = tr.ops_in(lay["trace"], lay["lo"], lay["hi"])
    if not lay["frames"] or not ops:
        return None
    return len(ops) / len(lay["frames"])
