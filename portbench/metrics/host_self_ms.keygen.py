"""Host milliseconds a Lagrange key in which the host did not wait on the
card: the program's span "lagrange key" (the stage around
api.crs_lagrange_form) less its "device wait" spans, from each request's
profiling.last_timings (a key with no wait: all of it), mean over the
window's keys.  None where the program has no such span."""

KEY, WAIT = "lagrange key", "device wait"


def read(ctx):
    got = [s[KEY] - s.get(WAIT, 0.0) for s in ctx.stages if KEY in s]
    return sum(got) / len(got) * 1e3 if got else None
