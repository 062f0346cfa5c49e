"""Share of the traced window, from the first key's derivation's start to
the last one's end, in which nothing ran on the device (profiler's trace)."""


def read(ctx):
    if not ctx.span_s or not ctx.busy_s:
        return None
    return (1 - ctx.busy_s / ctx.span_s) * 100
