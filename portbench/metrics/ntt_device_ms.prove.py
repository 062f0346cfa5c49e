"""Device milliseconds a proof of the NTT engines: the tensor-core engine's
K9 balanced_digits, K10 dft_product and K11 fold_redc (gpu/ntt_mxu.py) and
the butterflies K3 and K5 (gpu/ntt.py), from the profiler's trace."""

from portbench.trace import device_seconds

KERNELS = ("balanced_digits_kernel", "dft_product_kernel", "fold_redc_kernel",
           "butterfly_dif_kernel", "butterfly_dit_kernel")


def read(ctx):
    s = device_seconds(ctx.by_name, KERNELS)
    return s / ctx.completed * 1e3 if s and ctx.completed else None
