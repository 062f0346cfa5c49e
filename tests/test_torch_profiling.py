"""The run-time switches that the port reads as plonkit_tpu does:

- PLONKIT_TPU_SYNC_STAGES (plonkit_tpu/profiling.py): `stage` synchronizes
  on entry and exit unless the variable is 0, in both packages alike;
- PLONKIT_TPU_TRACE: one readable Chrome trace a stage, under the name the
  JAX package gives its trace directory, inner stages marked in their outer
  stage's trace, `last_timings` as without the trace; trace_summary charges
  copies and kernels to the innermost stage;
- backend_torch.SPLIT_NTT_MIN is the default of plonkit_tpu/backend_jax.py's
  PLONKIT_TPU_SPLIT_NTT_MIN, which the port does not read (test_torch_ntt.py
  holds the split transforms against the monolithic ones).
"""

import contextlib
import json
import os
import subprocess
import sys

import pytest

from plonkit_tpu_torch import profiling, trace_summary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a stage in a fresh interpreter, its package's sync_device counted
COUNT_SYNCS = r'''
import importlib, sys
prof = importlib.import_module(sys.argv[1] + ".profiling")
calls = []
prof.sync_device = lambda: calls.append(1)
with prof.stage("a stage"):
    pass
print(len(calls))
'''


def _python(code, *args, env=None):
    """Run code in a fresh interpreter with env's variables set (None:
    unset); returns the last word it printed."""
    full = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    for k, v in dict({"PLONKIT_TPU_TRACE": None}, **(env or {})).items():
        full.pop(k, None)
        if v is not None:
            full[k] = v
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, env=full,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.split()[-1]


@pytest.mark.parametrize("package", ["plonkit_tpu", "plonkit_tpu_torch"])
@pytest.mark.parametrize("value,syncs", [(None, 2), ("1", 2), ("0", 0)],
                         ids=["unset", "on", "off"])
def test_sync_stages_variable(package, value, syncs):
    """A stage synchronizes on entry and exit unless the variable is 0."""
    env = {"PLONKIT_TPU_SYNC_STAGES": value}
    assert int(_python(COUNT_SYNCS, package, env=env)) == syncs


def test_stage_sync_switch(monkeypatch):
    calls = []
    monkeypatch.setattr(profiling, "sync_device", lambda: calls.append(1))
    monkeypatch.setattr(profiling, "_SYNC", True)
    with profiling.stage("synced"):
        assert len(calls) == 1
    assert len(calls) == 2
    monkeypatch.setattr(profiling, "_SYNC", False)
    with profiling.stage("off"):
        pass
    assert len(calls) == 2


def _jax_trace_dirs(monkeypatch, trace_dir, names):
    """The directories plonkit_tpu's stage hands jax.profiler.trace."""
    import jax
    from plonkit_tpu import profiling as ref_profiling
    seen = []

    @contextlib.contextmanager
    def trace(path):
        seen.append(path)
        yield

    monkeypatch.setattr(jax.profiler, "trace", trace)
    monkeypatch.setenv("PLONKIT_TPU_TRACE", trace_dir)
    for name in names:
        with ref_profiling.stage(name, sync=False):
            pass
    return seen


STAGES = ("aggregation: prove2", "x r1 wires: intt + 4 commits")


def _run_stages():
    import torch
    profiling.reset()
    with profiling.stage(STAGES[0]):
        a = torch.arange(64) * 3
        with profiling.stage(STAGES[1]):
            a = a + 1
    with profiling.stage("msm"):
        a = a * a
    return dict.fromkeys(profiling.last_timings)


def test_trace_writes_one_chrome_trace_a_stage(monkeypatch, tmp_path):
    monkeypatch.delenv("PLONKIT_TPU_TRACE", raising=False)
    untraced = _run_stages()
    monkeypatch.setenv("PLONKIT_TPU_TRACE", str(tmp_path))
    assert _run_stages() == untraced
    want = _jax_trace_dirs(monkeypatch, str(tmp_path / "jax"), (STAGES[0], "msm"))
    files = sorted(os.listdir(tmp_path))
    assert files == sorted(os.path.basename(p) + ".json" for p in want)
    assert files == ["aggregation:_prove2.json", "msm.json"]
    for name in (STAGES[0], "msm"):
        with open(profiling.trace_path(str(tmp_path), name)) as f:
            events = json.load(f)["traceEvents"]
        spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
        # the inner stage writes no file: it is a span in its outer stage's trace
        assert spans == ([STAGES[0], STAGES[1]] if name == STAGES[0] else ["msm"])
    summary = trace_summary.summarize(str(tmp_path))
    assert set(summary) == {"aggregation:_prove2", "msm"}


def test_trace_summary_charges_the_innermost_stage(tmp_path):
    """A synthetic trace in torch.profiler's format: copies and kernels go to
    the shortest stage span that holds their launching host call."""
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}
    events = [x("user_annotation", "outer", 0, 100), x("user_annotation", "inner", 10, 20),
              x("cuda_runtime", "cudaMemcpyAsync", 5, 1, correlation=1),
              x("cuda_runtime", "cudaMemcpyAsync", 15, 1, correlation=2),
              x("cuda_runtime", "cudaMemcpyAsync", 16, 1, correlation=3),
              x("cuda_runtime", "cudaLaunchKernel", 40, 1, correlation=4),
              x("cuda_runtime", "cudaMemcpyAsync", 200, 1, correlation=5),
              x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 6, 2000, correlation=1,
                bytes=4096),
              x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 16, 1000, correlation=2,
                bytes=1 << 20),
              x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 17, 1000, correlation=3,
                bytes=1 << 20),
              x("kernel", "mul_kernel", 41, 500, correlation=4),
              x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 201, 3, correlation=5,
                bytes=32)]
    path = tmp_path / "outer.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = trace_summary.summarize_trace(str(path))
    assert got["outer"]["copies"] == {"HtoD pageable": {
        "count": 1, "bytes": 4096, "ms": 2.0, "largest": [{"bytes": 4096, "count": 1}]}}
    assert got["outer"]["kernels"] == {"count": 1, "ms": 0.5}
    assert got["inner"]["copies"]["HtoD pinned"] == {
        "count": 2, "bytes": 2 << 20, "ms": 2.0, "largest": [{"bytes": 1 << 20, "count": 2}]}
    assert got["(outside a stage)"]["copies"]["DtoH"]["bytes"] == 32


def test_split_ntt_min_is_backend_jax_default():
    """The port's constant is backend_jax's threshold with its variable
    unset (read when backend_jax is imported, so in a fresh interpreter)."""
    from plonkit_tpu_torch import backend_torch
    ref = _python("from plonkit_tpu import backend_jax; print(backend_jax._SPLIT_NTT_MIN)",
                  env={"PLONKIT_TPU_SPLIT_NTT_MIN": None})
    assert backend_torch.SPLIT_NTT_MIN == int(ref) == 1 << 24
