"""Times the host waits on the card a proof: the program's own counter
`device_waits` (profiling.counts(): each blocking copy between host and
card and each synchronisation), recorded after every
api.SetupForProver.prove call and read as device_waits.keygen reads it:
the window's last record less the set-up's last, over the window's
proofs.  None where the program keeps no such counter."""

from portbench import workload

_counter = workload.load("metrics", "device_waits.keygen")

PROBES = [("plonkit_tpu_torch.api", "SetupForProver.prove", _counter.record)]


def read(ctx):
    return _counter.per_call(ctx.store, "device_waits")
