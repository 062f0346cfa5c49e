"""The run-time switches that the port reads as plonkit_tpu does:

- PLONKIT_TPU_SYNC_STAGES (plonkit_tpu/profiling.py): `stage` synchronizes
  on entry and exit unless the variable is 0, in both packages alike;
- PLONKIT_TPU_TRACE: one readable Chrome trace a stage, under the name the
  JAX package gives its trace directory, inner stages marked in their outer
  stage's trace, `last_timings` as without the trace; trace_summary charges
  copies and kernels to the innermost stage, passing over device waits;
- backend_torch.SPLIT_NTT_MIN is the default of plonkit_tpu/backend_jax.py's
  PLONKIT_TPU_SPLIT_NTT_MIN, which the port does not read (test_torch_ntt.py
  holds the split transforms against the monolithic ones);
- the port's own spans and counters: a span never synchronizes, nests and
  adds up in `last_timings`, makes no torch call untraced, marks itself in
  its stage's trace or under `recording()` and writes no file; a device
  wait is counted always and is a span only while a trace records; `counts()`
  is cumulative and lists every kernel module's launches; the Lagrange key
  on the CPU names its parts by span and counts no wait and no byte (the
  card's counts are held against torch's own in tests/test_torch_cuda.py).
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


@pytest.mark.parametrize("env,sync,syncs", [(True, None, 2), (False, None, 0), (True, False, 0),
                                             (False, True, 2)])
def test_stage_sync_argument(monkeypatch, env, sync, syncs):
    """`sync=` decides for one stage, as plonkit_tpu's stage(name, sync);
    None takes PLONKIT_TPU_SYNC_STAGES's setting."""
    calls = []
    monkeypatch.setattr(profiling, "sync_device", lambda: calls.append(1))
    monkeypatch.setattr(profiling, "_SYNC", env)
    with profiling.stage("a stage", sync=sync):
        pass
    assert len(calls) == syncs


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


def test_trace_summary_passes_over_device_waits(tmp_path):
    """A copy made inside a "device wait" span (gpu/mont.upload's blocking
    copy) is charged to the stage around the wait, not to the wait."""
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}
    events = [x("user_annotation", "lagrange key", 0, 100),
              x("user_annotation", "lagrange key: points in", 10, 50),
              x("user_annotation", profiling.DEVICE_WAIT, 20, 5),
              x("user_annotation", profiling.DEVICE_WAIT, 70, 5),
              x("cuda_runtime", "cudaMemcpyAsync", 21, 1, correlation=1),
              x("cuda_runtime", "cudaMemcpyAsync", 71, 1, correlation=2),
              x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 22, 2, correlation=1,
                bytes=4096),
              x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 72, 2, correlation=2,
                bytes=64)]
    path = tmp_path / "lagrange_key.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = trace_summary.summarize_trace(str(path))
    assert set(got) == {"lagrange key", "lagrange key: points in"}
    assert got["lagrange key: points in"]["copies"]["HtoD pageable"]["bytes"] == 4096
    assert got["lagrange key"]["copies"]["DtoH"]["bytes"] == 64


def test_device_wait_counts_and_is_a_span_only_traced(monkeypatch):
    import torch

    def refuse(*args, **kwargs):
        raise AssertionError("a torch call in an untraced wait")
    monkeypatch.setattr(profiling, "_counters", dict(profiling._counters))
    monkeypatch.setattr(profiling, "_tracing", {"active": False})
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset()
    before = profiling.counts()["device_waits"]
    with profiling.device_wait():
        pass
    assert profiling.counts()["device_waits"] == before + 1
    assert profiling.DEVICE_WAIT not in profiling.last_timings
    monkeypatch.undo()
    monkeypatch.setattr(profiling, "_counters", dict(profiling._counters))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.recording():
            with profiling.device_wait():
                torch.arange(8).sum()
    assert profiling.DEVICE_WAIT in profiling.last_timings
    assert profiling.DEVICE_WAIT in [e.name for e in prof.events()]


def test_split_ntt_min_is_backend_jax_default():
    """The port's constant is backend_jax's threshold with its variable
    unset (read when backend_jax is imported, so in a fresh interpreter)."""
    from plonkit_tpu_torch import backend_torch
    ref = _python("from plonkit_tpu import backend_jax; print(backend_jax._SPLIT_NTT_MIN)",
                  env={"PLONKIT_TPU_SPLIT_NTT_MIN": None})
    assert backend_torch.SPLIT_NTT_MIN == int(ref) == 1 << 24


def test_span_never_synchronizes(monkeypatch):
    calls = []
    monkeypatch.setattr(profiling, "sync_device", lambda: calls.append(1))
    monkeypatch.setattr(profiling, "_SYNC", True)
    with profiling.span("a span"):
        with profiling.span("an inner span"):
            pass
    assert calls == []


def test_spans_nest_and_add_up():
    import time
    profiling.reset()
    with profiling.span("outer"):
        for _ in range(2):
            with profiling.span("inner") as inner:
                time.sleep(0.01)
            assert inner.seconds >= 0.01
    got = dict(profiling.last_timings)
    assert set(got) == {"outer", "inner"}
    assert got["outer"] >= got["inner"] >= 0.02


def test_untraced_span_makes_no_torch_call(monkeypatch):
    import torch

    def refuse(*args, **kwargs):
        raise AssertionError("a torch call in an untraced span")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(profiling, "_tracing", {"active": False})
    with profiling.span("untraced"):
        pass
    assert "untraced" in profiling.last_timings


def _annotations(events):
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def test_span_marks_itself_in_its_stage_trace(monkeypatch, tmp_path):
    import torch
    monkeypatch.setenv("PLONKIT_TPU_TRACE", str(tmp_path))
    profiling.reset()
    with profiling.stage("a stage"):
        with profiling.span("a span"):
            torch.arange(8).sum()
    assert os.listdir(tmp_path) == ["a_stage.json"]
    with open(tmp_path / "a_stage.json") as f:
        assert _annotations(json.load(f)["traceEvents"]) == ["a stage", "a span"]
    assert set(profiling.last_timings) == {"a stage", "a span"}


def test_recording_marks_spans_and_writes_nothing(monkeypatch, tmp_path):
    import torch
    monkeypatch.setenv("PLONKIT_TPU_TRACE", str(tmp_path / "never"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.recording():
            with profiling.stage("a stage"):
                with profiling.span("a span"):
                    torch.arange(8).sum()
    assert profiling._tracing["active"] is False
    assert not os.path.exists(tmp_path / "never")
    prof.export_chrome_trace(str(tmp_path / "mine.json"))
    with open(tmp_path / "mine.json") as f:
        assert _annotations(json.load(f)["traceEvents"]) == ["a stage", "a span"]


def test_counts_are_cumulative_and_list_every_launch(monkeypatch):
    from plonkit_tpu_torch.gpu import field_kernels, group_ntt, msm_kernels, ntt, ntt_mxu
    monkeypatch.setattr(profiling, "_counters", dict(profiling._counters))
    first = profiling.counts()
    profiling.count("h2d_bytes", 96)
    profiling.count("device_waits")
    profiling.reset()
    profiling.count("device_waits")
    got = profiling.counts()
    assert (got["h2d_bytes"] - first["h2d_bytes"], got["device_waits"] - first["device_waits"]) \
        == (96, 2)
    launches = {f"launches.{k}": v for m in (field_kernels, group_ntt, msm_kernels, ntt, ntt_mxu)
                for k, v in m.launches.items()}
    assert len(launches) == 20 and {k: got[k] for k in launches} == launches
    assert set(got) == {"device_waits", "h2d_bytes", "g1_lane_groups",
                        "g1_split_products"} | set(launches)


KEY_SPANS = {"lagrange key", "lagrange key: points in", "group ntt: twiddles",
             "group ntt: butterflies", "group ntt: scale", "group ntt: affine",
             "lagrange key: limbs out"}


def test_lagrange_key_spans_on_the_cpu():
    """A 2^4 key of the in-repo tau = 42 key through the plain versions:
    [L_i(42)] G lane by lane, its parts named by span, no wait, no byte."""
    _lagrange_key_by_span(16)


def test_lagrange_key_spans_at_2p8_on_the_cpu():
    """The same at 2^8: eight in-place stages, the same six spans."""
    _lagrange_key_by_span(256)


def _lagrange_key_by_span(n: int):
    from plonkit_tpu_torch import api
    from plonkit_tpu_torch.curve import G1_GEN, g1_mul
    from plonkit_tpu_torch.fields import FR_MODULUS as R, fr_inv, get_domain_omega
    from plonkit_tpu_torch.gpu.mont import FQ
    from plonkit_tpu_torch.serialization import CrsHandle
    from test_torch_prove import KEY
    tau = 42
    before = profiling.counts()
    profiling.reset()
    x, y, inf = api.crs_lagrange_form(CrsHandle(KEY), n, device="cpu").g1_limbs()
    assert set(profiling.last_timings) == KEY_SPANS
    after = profiling.counts()
    assert {k: after[k] - before[k] for k in ("device_waits", "h2d_bytes")} == \
        {"device_waits": 0, "h2d_bytes": 0}
    w_inv = fr_inv(get_domain_omega(n))
    lagrange = [fr_inv(n) * sum(pow(tau, j, R) * pow(w_inv, i * j, R) for j in range(n)) % R
                for i in range(n)]
    assert not inf.any()
    assert list(zip(FQ.from_limbs_np(x), FQ.from_limbs_np(y))) == \
        [g1_mul(G1_GEN, s) for s in lagrange]
