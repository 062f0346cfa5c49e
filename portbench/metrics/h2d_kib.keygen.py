"""KiB copied from host to card a Lagrange key: the program's own counter
`h2d_bytes` (profiling.counts(): the source bytes of each copy to the card),
read as device_waits.keygen reads its counter."""

from portbench import workload

_counter = workload.load("metrics", "device_waits.keygen")

PROBES = [("plonkit_tpu_torch.api", "crs_lagrange_form", _counter.record)]


def read(ctx):
    got = _counter.per_call(ctx.store, "h2d_bytes")
    return None if got is None else got / 1024
