"""Seconds a proof of the prover's five rounds (the program's spans "r1 .."
to "r5 .." of plonk/prover.py), mean over the window's proofs."""

ROUNDS = ("r1 ", "r2 ", "r3 ", "r4 ", "r5 ")


def read(ctx):
    got = [sum(v for k, v in s.items() if k.startswith(ROUNDS)) for s in ctx.stages
           if sum(k.startswith(ROUNDS) for k in s) == len(ROUNDS)]
    return sum(got) / len(got) if got else None
