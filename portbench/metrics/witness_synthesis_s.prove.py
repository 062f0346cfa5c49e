"""Seconds a proof of the program's span "witness synthesis" (the witness
plan's evaluation and the columns' upload), mean over the window's proofs."""


def read(ctx):
    got = [s["witness synthesis"] for s in ctx.stages if "witness synthesis" in s]
    return sum(got) / len(got) if got else None
