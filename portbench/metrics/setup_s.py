"""Set-up: process start to the first timed request (imports, the kernels'
libraries from the build cache, keys made on the card, circuit, prover
set-up, witness pool, warm-up), host clock."""


def read(ctx):
    return ctx.setup_s
