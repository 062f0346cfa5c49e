"""Per-stage wall-time tracing for the prover.

- `stage(name)`: context manager logging wall time per prover stage at
  INFO, accumulated in the module-level `last_timings` dict.  When the
  process has used the card, stage entry and exit call
  `torch.cuda.synchronize()`, so a stage that only enqueues kernels is not
  reported as free and its cost does not surface in whichever stage
  synchronizes next.
"""

import logging
import time
from contextlib import contextmanager

log = logging.getLogger("plonkit_tpu_torch")

last_timings = {}


def sync_device():
    """Wait for every kernel queued on the card; a no-op in a process that
    never touched CUDA (the CPU tests)."""
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def stage(name: str):
    sync_device()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sync_device()
        dt = time.perf_counter() - t0
        last_timings[name] = last_timings.get(name, 0.0) + dt
        log.info("[stage] %-28s %8.2fs", name, dt)


def reset():
    last_timings.clear()
