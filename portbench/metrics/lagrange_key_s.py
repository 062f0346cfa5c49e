"""The window's length over the Lagrange keys derived in it, host clock."""


def read(ctx):
    return ctx.window_s / ctx.completed if ctx.completed else None
