"""Per-stage wall-time tracing for the prover, with the run-time switches
of plonkit_tpu/profiling.py, and the port's counters.

- `stage(name)`: context manager logging wall time per prover
  stage at INFO, accumulated in the module-level `last_timings` dict.  When
  the process has used the card, stage entry and exit call
  `torch.cuda.synchronize()`, so a stage that only enqueues kernels is not
  reported as free and its cost does not surface in whichever stage
  synchronizes next.  PLONKIT_TPU_SYNC_STAGES=0 skips the synchronization
  (timings become the host's dispatch times); `sync=` decides it for one
  stage, as in the JAX package.
- `span(name)`: the inner form of a stage, for parts of a request.  It
  never synchronizes, writes no file and logs nothing; it adds its host
  seconds to `last_timings[name]`, and while a trace records (below) it is
  a `torch.profiler.record_function` of its name, on the profiler's clock.
  Untraced it makes no torch call.
- PLONKIT_TPU_TRACE=<dir>: the stage runs under a `torch.profiler.profile`
  (host and CUDA activities) that writes a Chrome trace to
  `<dir>/<name with "_" for " ">.json` on exit (the JAX package writes a
  jax.profiler trace into the directory of that name); a stage run again
  writes its file again.  A stage entered
  inside a traced one writes no file of its own: it shows in its outer
  stage's trace as a `record_function` span of its name, which is how
  `trace_summary.py` attributes device work to the innermost stage.
- `recording()`: marks stages and spans as spans, and writes no file, for
  a caller that runs its own `torch.profiler`.
- `count(name, n)` / `counts()`: counters cumulative from process start
  (`reset()` leaves them).  `device_waits` counts the times the host
  blocked on the card (each also a "device wait" span), `h2d_bytes` the
  source bytes copied from host to card; gpu/mont.upload, gpu/mont.download
  and sync_device count them, and only when the copy or wait is the card's
  (the "device wait" span, and so its `last_timings` entry, only while a
  trace records).
  `counts()` also lists each kernel module's `launches` dict
  (`register_launches`) as `launches.<kernel>`.
"""

import logging
import os
import time
from contextlib import contextmanager, nullcontext

log = logging.getLogger("plonkit_tpu_torch")

last_timings = {}

_SYNC = os.environ.get("PLONKIT_TPU_SYNC_STAGES", "1") != "0"

# "active": a torch.profiler records, so stages and spans mark themselves
_tracing = {"active": False}

DEVICE_WAIT = "device wait"

_counters = {"device_waits": 0, "h2d_bytes": 0}
_launches = []


class span:
    """The host seconds of a block, added to `last_timings[name]`; a
    `record_function` span of its name while a trace records."""

    __slots__ = ("name", "seconds", "_t0", "_mark")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._mark = None
        if _tracing["active"]:
            import torch
            self._mark = torch.profiler.record_function(self.name)
            self._mark.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        last_timings[self.name] = last_timings.get(self.name, 0.0) + self.seconds
        if self._mark is not None:
            self._mark.__exit__(*exc)


_UNTIMED = nullcontext()


def device_wait():
    """A block in which the host waits on the card: one `device_waits`, and
    while a trace records a span of DEVICE_WAIT.  Untraced the wait is
    counted and not timed, so the hot path pays one dict update a wait."""
    _counters["device_waits"] += 1
    return span(DEVICE_WAIT) if _tracing["active"] else _UNTIMED


def count(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def register_launches(table: dict) -> None:
    """List a kernel module's `launches` dict in counts() as
    `launches.<kernel>`."""
    _launches.append(table)


def counts() -> dict:
    """A flat snapshot of every counter."""
    out = dict(_counters)
    for table in _launches:
        out.update((f"launches.{k}", v) for k, v in table.items())
    return out


def sync_device():
    """Wait for every kernel queued on the card; a no-op in a process that
    never touched CUDA (the CPU tests)."""
    import torch
    if torch.cuda.is_initialized():
        with device_wait():
            torch.cuda.synchronize()


def trace_path(trace_dir: str, name: str) -> str:
    """The Chrome trace file of stage `name` under `trace_dir`."""
    return os.path.join(trace_dir, name.replace(" ", "_") + ".json")


@contextmanager
def recording():
    """Stages and spans inside mark themselves in the caller's own
    torch.profiler; no file is written."""
    was = _tracing["active"]
    _tracing["active"] = True
    try:
        yield
    finally:
        _tracing["active"] = was


@contextmanager
def _trace_file(name: str):
    """PLONKIT_TPU_TRACE's profiler around an outermost stage, its Chrome
    trace written on exit."""
    import torch
    trace_dir = os.environ["PLONKIT_TPU_TRACE"]
    os.makedirs(trace_dir, exist_ok=True)
    acts = [a for a in (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
            if a in torch.profiler.supported_activities()]
    with torch.profiler.profile(activities=acts) as prof:
        with recording():
            yield
    prof.export_chrome_trace(trace_path(trace_dir, name))


@contextmanager
def stage(name: str, sync: bool = None):
    """A span of `name` between two synchronizations of the card (`sync`,
    PLONKIT_TPU_SYNC_STAGES's by default; the argument is the JAX package's
    stage(name, sync=None)), logged; the outermost stage under
    PLONKIT_TPU_TRACE writes its trace file."""
    traced = os.environ.get("PLONKIT_TPU_TRACE") and not _tracing["active"]
    do_sync = _SYNC if sync is None else sync
    with _trace_file(name) if traced else nullcontext():
        if do_sync:
            sync_device()
        timed = span(name)
        try:
            with timed:
                try:
                    yield
                finally:
                    if do_sync:
                        sync_device()
        finally:
            log.info("[stage] %-28s %8.2fs", name, timed.seconds)


def reset():
    last_timings.clear()
