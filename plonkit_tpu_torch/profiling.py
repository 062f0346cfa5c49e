"""Per-stage wall-time tracing for the prover, with the run-time switches
of plonkit_tpu/profiling.py.

- `stage(name)`: context manager logging wall time per prover
  stage at INFO, accumulated in the module-level `last_timings` dict.  When
  the process has used the card, stage entry and exit call
  `torch.cuda.synchronize()`, so a stage that only enqueues kernels is not
  reported as free and its cost does not surface in whichever stage
  synchronizes next.  PLONKIT_TPU_SYNC_STAGES=0 skips the synchronization
  (timings become the host's dispatch times).
- PLONKIT_TPU_TRACE=<dir>: the stage runs under a `torch.profiler.profile`
  (host and CUDA activities) that writes a Chrome trace to
  `<dir>/<name with "_" for " ">.json` on exit (the JAX package writes a
  jax.profiler trace into the directory of that name); a stage run again
  writes its file again.  A stage entered
  inside a traced one writes no file of its own: it shows in its outer
  stage's trace as a `record_function` span of its name, which is how
  `trace_summary.py` attributes device work to the innermost stage.
"""

import logging
import os
import time
from contextlib import contextmanager, nullcontext

log = logging.getLogger("plonkit_tpu_torch")

last_timings = {}

_SYNC = os.environ.get("PLONKIT_TPU_SYNC_STAGES", "1") != "0"

_tracing = {"active": False}


def sync_device():
    """Wait for every kernel queued on the card; a no-op in a process that
    never touched CUDA (the CPU tests)."""
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def trace_path(trace_dir: str, name: str) -> str:
    """The Chrome trace file of stage `name` under `trace_dir`."""
    return os.path.join(trace_dir, name.replace(" ", "_") + ".json")


@contextmanager
def _traced(name: str):
    """PLONKIT_TPU_TRACE's profiler around a stage: the outermost traced
    stage profiles and writes its file, inner ones mark their span."""
    import torch
    if _tracing["active"]:
        with torch.profiler.record_function(name):
            yield
        return
    trace_dir = os.environ["PLONKIT_TPU_TRACE"]
    os.makedirs(trace_dir, exist_ok=True)
    acts = [a for a in (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
            if a in torch.profiler.supported_activities()]
    _tracing["active"] = True
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(name):
                yield
    finally:
        _tracing["active"] = False
    prof.export_chrome_trace(trace_path(trace_dir, name))


@contextmanager
def stage(name: str):
    with _traced(name) if os.environ.get("PLONKIT_TPU_TRACE") else nullcontext():
        if _SYNC:
            sync_device()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if _SYNC:
                sync_device()
            dt = time.perf_counter() - t0
            last_timings[name] = last_timings.get(name, 0.0) + dt
            log.info("[stage] %-28s %8.2fs", name, dt)


def reset():
    last_timings.clear()
