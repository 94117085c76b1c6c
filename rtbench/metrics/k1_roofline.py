"""K1 against its roofline on the first pass of the first traced frame:
the sum of each wave's bound (``rtbench.reference.bounds.k1_bound`` of
the work ``rtbench.reference.walk`` counts on that wave's own rays)
over the sum of the same waves' K1 device time (the frame's first K1
launches, one a wave), in %."""

from rtbench import trace as tr


def read(ctx):
    lay = ctx["layer"]
    bounds = lay.get("k1_bounds_ms")
    if not bounds or not lay["frames"]:
        return None
    f0, f1 = lay["frames"][0]
    k1 = [o for o in tr.ops_in(lay["trace"], f0, f1)
          if tr.kernel_of(o.name) in tr.K1]
    if len(k1) < len(bounds):
        return None
    ms = sum(o.end - o.start for o in k1[:len(bounds)]) * 1e3
    return 100.0 * sum(bounds) / ms if ms > 0 else None
