"""K10 dft_product's share of its roofline over the window: the least time
of every launch (yardstick.k10_least_seconds, from its shapes) over the
device time of all of them."""

from portbench import yardstick
from portbench.trace import device_seconds


def _record(store, args, out):
    a, x = args[:2]
    if a.is_cuda and out.numel():
        store.add((a.shape[0], x.shape[0], a.shape[1]))


PROBES = [("plonkit_tpu_torch.gpu.ntt_mxu", "dft_product", _record)]


def read(ctx):
    launches = ctx.store.items["window"]
    count = sum(c for n, (c, _) in ctx.by_name.items() if "dft_product_kernel" in n)
    measured = device_seconds(ctx.by_name, ("dft_product_kernel",))
    if not launches or count != len(launches) or not measured:
        return None
    least = sum(yardstick.k10_least_seconds(m, n, kp) for m, n, kp in launches)
    return least / measured * 100
