"""The readers of the program's own counters and spans on the Lagrange-key
path (device_waits.keygen, h2d_kib.keygen, host_self_ms.keygen): the
window's growth per call, and nothing read, never an error, from a program
that lacks the counter or the span."""

from types import SimpleNamespace

import pytest

from portbench import trace, workload


def _reader(name):
    return workload.load("metrics", name)


def _ctx(store=None, stages=()):
    return SimpleNamespace(store=store, stages=list(stages))


def test_counters_grow_per_call(monkeypatch):
    from plonkit_tpu_torch import profiling
    monkeypatch.setattr(profiling, "_counters", {"device_waits": 5, "h2d_bytes": 100})
    waits, kib = _reader("device_waits.keygen"), _reader("h2d_kib.keygen")
    store = trace.Store()
    waits.record(store, (), None)
    store.phase = "window"
    for _ in range(4):
        profiling.count("device_waits", 25)
        profiling.count("h2d_bytes", 3 * 1024)
        waits.record(store, (), None)
    assert waits.read(_ctx(store)) == 25
    assert kib.read(_ctx(store)) == 3
    assert waits.PROBES[0][:2] == kib.PROBES[0][:2] == ("plonkit_tpu_torch.api",
                                                         "crs_lagrange_form")


def test_counters_read_nothing_without_the_program_counter(monkeypatch):
    from plonkit_tpu_torch import profiling
    monkeypatch.delattr(profiling, "counts")
    waits, kib = _reader("device_waits.keygen"), _reader("h2d_kib.keygen")
    store = trace.Store()
    waits.record(store, (), None)
    store.phase = "window"
    waits.record(store, (), None)
    assert store.items == {"warmup": [], "window": []}
    assert waits.read(_ctx(store)) is None and kib.read(_ctx(store)) is None


@pytest.mark.parametrize("stages,want", [
    ([{"lagrange key": 0.010, "device wait": 0.004, "group ntt: scale": 0.001},
      {"lagrange key": 0.012, "device wait": 0.002}], 8.0),
    ([{"portbench request": 0.01}], None),
    ([{"lagrange key": 0.010}], 10.0),
])
def test_host_self_time(stages, want):
    got = _reader("host_self_ms.keygen").read(_ctx(stages=stages))
    assert got == (None if want is None else pytest.approx(want))
