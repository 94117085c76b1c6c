"""``torch.cuda.max_memory_allocated()`` over the window (reset at its
start), in GiB; nothing off the card."""


def read(ctx):
    peak = ctx["window"].peak_bytes
    return peak / 2.0 ** 30 if peak > 0 else None
