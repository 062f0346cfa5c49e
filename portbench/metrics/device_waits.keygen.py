"""Times the host waits on the card a Lagrange key: the program's own
counter `device_waits` (profiling.counts(): each blocking copy between host
and card and each synchronisation), recorded after every
api.crs_lagrange_form call; the window's last record less the set-up's
last, over the window's calls.  None where the program keeps no such
counter."""


def record(store, args, out):
    from plonkit_tpu_torch import profiling
    counts = getattr(profiling, "counts", None)
    if counts is not None:
        store.add(counts())


PROBES = [("plonkit_tpu_torch.api", "crs_lagrange_form", record)]


def per_call(store, name: str):
    """The counter `name`'s growth over the window, per call recorded."""
    warm, window = store.items["warmup"], store.items["window"]
    if not warm or not window or name not in window[-1] or name not in warm[-1]:
        return None
    return (window[-1][name] - warm[-1][name]) / len(window)


def read(ctx):
    return per_call(ctx.store, "device_waits")
