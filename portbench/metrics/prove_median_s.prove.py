"""The median host seconds of one proof in the traced window (entry:
api.SetupForProver.prove)."""

import statistics


def read(ctx):
    return statistics.median(ctx.request_s) if ctx.request_s else None
