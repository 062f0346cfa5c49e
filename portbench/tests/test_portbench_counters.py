"""The readers of the program's own counters and spans on the Lagrange-key
path (device_waits.keygen, h2d_kib.keygen, host_self_ms.keygen) and on the
prove path (device_waits.prove, h2d_kib.prove): the window's growth per
call, and nothing read, never an error, from a program that lacks the
counter or the span; and the probe of a method, SetupForProver.prove."""

import os
from types import SimpleNamespace

import pytest

from portbench import trace, workload

HERE = os.path.dirname(os.path.abspath(__file__))


def _reader(name):
    return workload.load("metrics", name)


def _ctx(store=None, stages=()):
    return SimpleNamespace(store=store, stages=list(stages))


# each path's pair of readers, the function they probe, and its counts a
# call: a 2^12 Lagrange key's and a warm 2^12 proof's (PERF.md)
PATHS = {"keygen": ("crs_lagrange_form", 2, 266_272),
         "prove": ("SetupForProver.prove", 75, 685_248)}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_counters_grow_per_call(monkeypatch, path):
    from plonkit_tpu_torch import profiling
    monkeypatch.setattr(profiling, "_counters", {"device_waits": 5, "h2d_bytes": 100})
    attr, waits_each, bytes_each = PATHS[path]
    waits, kib = _reader(f"device_waits.{path}"), _reader(f"h2d_kib.{path}")
    store = trace.Store()
    for _ in range(2):                          # the set-up's warm-up calls
        profiling.count("device_waits", 3)
        waits.PROBES[0][2](store, (), None)
    store.phase = "window"
    for _ in range(4):
        profiling.count("device_waits", waits_each)
        profiling.count("h2d_bytes", bytes_each)
        waits.PROBES[0][2](store, (), None)
    assert waits.read(_ctx(store)) == waits_each
    assert kib.read(_ctx(store)) == bytes_each / 1024
    assert waits.PROBES[0][:2] == kib.PROBES[0][:2] == ("plonkit_tpu_torch.api", attr)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_counters_read_nothing_without_the_program_counter(monkeypatch, path):
    from plonkit_tpu_torch import profiling
    monkeypatch.delattr(profiling, "counts")
    waits, kib = _reader(f"device_waits.{path}"), _reader(f"h2d_kib.{path}")
    store = trace.Store()
    waits.PROBES[0][2](store, (), None)
    store.phase = "window"
    waits.PROBES[0][2](store, (), None)
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



def test_prove_probe_wraps_the_method_and_is_removed(monkeypatch):
    """install_probes wraps a dotted "Class.method" of the port: every call
    records after the method returns, with the instance first in args, and
    remove_probes puts the method back."""
    from plonkit_tpu_torch import api
    calls = []

    def prove(self, circuit, transcript="keccak"):
        calls.append((circuit, transcript))
        return "proof"
    monkeypatch.setattr(api.SetupForProver, "prove", prove)
    store = trace.Store()
    seen = []
    undo = trace.install_probes(
        {"m": store}, {"m": [("plonkit_tpu_torch.api", "SetupForProver.prove",
                              lambda st, args, out: seen.append((args, out)))]})
    try:
        setup = object.__new__(api.SetupForProver)
        assert setup.prove("c", transcript="rescue") == "proof"
        assert calls == [("c", "rescue")] and seen == [((setup, "c"), "proof")]
    finally:
        trace.remove_probes(undo)
    assert api.SetupForProver.prove is prove


@pytest.mark.cuda
def test_prove_counters_on_the_card(card):
    """A traced run of the tiny backlog on the card reads both counters per
    proof through the probe on SetupForProver.prove: whole waits and bytes
    a proof, the same for every proof of the window."""
    from conftest import SEED, tiny_bench
    from portbench import run
    out = run.run_cell(tiny_bench(), "tiny.backlog", SEED, 2, True, device=card,
                       traffic_dir=os.path.join(HERE, "data", "traffic"))
    assert out["correct"]
    waits = out["metrics"]["device_waits.prove"]["value"]
    kib = out["metrics"]["h2d_kib.prove"]["value"]
    assert waits >= 1 and waits == int(waits)
    assert kib > 0 and (kib * 1024) == int(kib * 1024)
