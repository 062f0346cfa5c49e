"""The allocator's peak of device memory in the window (after a reset at
its start: torch.cuda.max_memory_allocated), GiB."""


def read(ctx):
    return ctx.window_peak_bytes / 2 ** 30 if ctx.window_peak_bytes else None
