"""Device milliseconds a proof of host-to-device copies, pageable and
pinned, from the profiler's trace of the window."""

from portbench.trace import device_seconds


def read(ctx):
    s = device_seconds(ctx.by_name, ("Memcpy HtoD",))
    return s / ctx.completed * 1e3 if s and ctx.completed else None
