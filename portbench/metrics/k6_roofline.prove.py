"""K6 bucket_sweep's share of its roofline over the window: the least time
of every launch (yardstick.k6_least_seconds, from the launch's entries,
non-empty segments and segment rows) over the device time of all of them.
The probe sums each launch's segment lengths on the device, so it waits
for nothing."""

from portbench import yardstick
from portbench.trace import device_seconds


def _record(store, args, out):
    _, _, seg_start, seg_len = args
    if seg_start.is_cuda:
        store.add((seg_len.sum(), (seg_len > 0).sum(), seg_start.shape[0]))


PROBES = [("plonkit_tpu_torch.gpu.msm_kernels", "bucket_sweep", _record)]


def read(ctx):
    launches = ctx.store.items["window"]
    count = ctx.by_name and sum(c for n, (c, _) in ctx.by_name.items()
                                if "bucket_sweep_kernel" in n)
    measured = device_seconds(ctx.by_name, ("bucket_sweep_kernel",))
    if not launches or count != len(launches) or not measured:
        return None
    least = sum(yardstick.k6_least_seconds(int(e), int(s), rows) for e, s, rows in launches)
    return least / measured * 100
