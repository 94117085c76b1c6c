"""Device ms a frame of the kernels that are not the port's hand-written
ones: PyTorch's gathers, the sampler's hash, elementwise ops, scans."""

from rtbench import trace as tr


def read(ctx):
    lay = ctx["layer"]
    ops = tr.ops_in(lay["trace"], lay["lo"], lay["hi"])
    if not lay["frames"] or not any(o.kind == "kernel" for o in ops):
        return None
    return tr.device_ms(ops, lambda o: o.kind == "kernel"
                        and tr.kernel_of(o.name) is None) / len(lay["frames"])
