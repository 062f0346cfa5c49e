"""Device milliseconds a Lagrange key of the group NTT (gpu/group_ntt.py):
K14 g1_butterfly and K15 g1_scale, from the profiler's trace."""

from portbench.trace import device_seconds

KERNELS = ("g1_butterfly_kernel", "g1_scale_kernel")


def read(ctx):
    s = device_seconds(ctx.by_name, KERNELS)
    return s / ctx.completed * 1e3 if s and ctx.completed else None
