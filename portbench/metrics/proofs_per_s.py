"""Proofs completed in the window over the window's length, host clock:
the window opens as the first request begins and closes as the last ends."""


def read(ctx):
    return ctx.completed / ctx.window_s if ctx.completed else None
