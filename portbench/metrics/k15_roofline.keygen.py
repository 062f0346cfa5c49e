"""K15 g1_scale's share of its roofline over the window: the least time of
every launch (yardstick.k15_least_seconds: its points and its one scalar)
over the device time of all of them."""

from portbench import yardstick
from portbench.trace import device_seconds


def _record(store, args, out):
    p, s = args[:2]
    if p[0].is_cuda and p[0].shape[0]:
        store.add((p[0].shape[0], s))


PROBES = [("plonkit_tpu_torch.gpu.group_ntt", "g1_scale", _record)]


def read(ctx):
    launches = ctx.store.items["window"]
    count = sum(c for n, (c, _) in ctx.by_name.items() if "g1_scale_kernel" in n)
    measured = device_seconds(ctx.by_name, ("g1_scale_kernel",))
    if not launches or count != len(launches) or not measured:
        return None
    cache = {}
    least = 0.0
    for points, s in launches:
        if (points, s) not in cache:
            cache[points, s] = yardstick.k15_least_seconds(points, s, "cuda")
        least += cache[points, s]
    return least / measured * 100
