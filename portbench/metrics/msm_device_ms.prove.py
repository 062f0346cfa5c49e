"""Device milliseconds a proof of the device MSM (gpu/msm.py): K6
bucket_sweep, K7 padd, K7r segment_fold, K7w window_sums, K8 combine and
the sort of the bucket keys, from the profiler's trace of the window."""

from portbench.trace import device_seconds

KERNELS = ("bucket_sweep_kernel", "padd_kernel", "segment_fold_kernel",
           "window_sums_kernel", "combine_kernel", "RadixSort")


def read(ctx):
    s = device_seconds(ctx.by_name, KERNELS)
    return s / ctx.completed * 1e3 if s and ctx.completed else None
