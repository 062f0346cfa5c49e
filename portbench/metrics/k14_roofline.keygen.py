"""K14 g1_butterfly's share of its roofline over the window: the least time
of every launch (yardstick.k14_least_seconds: each lane's twiddle, the least
work known for [w] P) over the device time of all of them.  The set-up's
warm-up keeps each launch's twiddles; a launch of the window is matched to
a warm-up launch of the same lanes and the same sums of its twiddles' first
and last limbs, taken on the device so that the window waits for nothing.
A launch with no match leaves the metric out."""

import numpy as np

from portbench import yardstick
from portbench.trace import device_seconds


def _record(store, args, out):
    import torch
    w = args[2]
    if not w.is_cuda or not w.shape[0]:
        return
    sums = (w[:, 0].to(torch.int64).sum(), w[:, 7].to(torch.int64).sum())
    if store.phase == "warmup":
        store.add((w.shape[0], int(sums[0]), int(sums[1]), w.cpu().numpy().view(np.uint32)))
    else:
        store.add((w.shape[0],) + sums)


PROBES = [("plonkit_tpu_torch.gpu.group_ntt", "g1_butterfly", _record)]


def _least_by_launch(rows: list) -> list:
    """The least seconds of each launch of twiddle rows, the least work of
    each distinct twiddle counted once."""
    from portbench.reference.bn254 import ints_of_rows
    every = np.concatenate(rows)
    key = every[:, 0].astype(np.uint64) | (every[:, 1].astype(np.uint64) << np.uint64(32))
    _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
    if not (every[first][inverse] == every).all():
        raise ValueError("two twiddles share their low 64 bits")
    ops = yardstick.least_glv_ops(ints_of_rows(every[first]), True, "cuda")[inverse]
    out, at = [], 0
    for r in rows:
        lanes = r.shape[0]
        out.append(yardstick.k14_least_seconds(lanes, int(ops[at:at + lanes].sum())))
        at += lanes
    return out


def read(ctx):
    warm, launches = ctx.store.items["warmup"], ctx.store.items["window"]
    count = sum(c for n, (c, _) in ctx.by_name.items() if "g1_butterfly_kernel" in n)
    measured = device_seconds(ctx.by_name, ("g1_butterfly_kernel",))
    if not warm or not launches or count != len(launches) or not measured:
        return None
    least = dict(zip(((n, s0, s7) for n, s0, s7, _ in warm),
                     _least_by_launch([r for *_, r in warm])))
    total = 0.0
    for n, s0, s7 in launches:
        key = (n, int(s0), int(s7))
        if key not in least:
            return None
        total += least[key]
    return total / measured * 100
