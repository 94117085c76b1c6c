"""Device ms a frame of K1, the 8- and 16-wide walk
(``traverse_packet_kernel``)."""

from rtbench import trace as tr


def read(ctx):
    lay = ctx["layer"]
    ms = tr.device_ms(tr.ops_in(lay["trace"], lay["lo"], lay["hi"]),
                      lambda o: tr.kernel_of(o.name) in tr.K1)
    return ms / len(lay["frames"]) if ms > 0 else None
