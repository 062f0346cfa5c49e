"""KiB copied from host to card a proof: the program's own counter
`h2d_bytes` (profiling.counts(): the source bytes of each copy to the card),
recorded after every api.SetupForProver.prove call and read as
device_waits.keygen reads its counter."""

from portbench import workload

_counter = workload.load("metrics", "device_waits.keygen")

PROBES = [("plonkit_tpu_torch.api", "SetupForProver.prove", _counter.record)]


def read(ctx):
    got = _counter.per_call(ctx.store, "h2d_bytes")
    return None if got is None else got / 1024
