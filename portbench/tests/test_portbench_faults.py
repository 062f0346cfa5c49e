"""The harness with the timed path broken underneath sees `correct` come out
false, for each fault these cells can have: a step that returns its state
unchanged (the first answer given again) and an answer altered where it is
produced.  A request answers one proof or one key, so no batch can lose
half of itself, and one chip exchanges nothing."""

import copy

import pytest

from conftest import run_tiny


def _first_again(fn):
    """Does the work of every call and answers the first call's answer."""
    seen = []

    def broken(*args, **kwargs):
        out = fn(*args, **kwargs)
        if not seen:
            seen.append(out)
        return seen[0]
    return broken


def _prove_altered(fn):
    def broken(self, *args, **kwargs):
        proof = copy.copy(fn(self, *args, **kwargs))
        proof.linearization_polynomial_at_z += 1
        return proof
    return broken


def _key_altered(fn):
    def broken(*args, **kwargs):
        key = fn(*args, **kwargs)
        key.x[3, 0] ^= 1
        return key
    return broken


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_prove_faults(monkeypatch, fault):
    from plonkit_tpu_torch import api
    fn = api.SetupForProver.prove
    monkeypatch.setattr(api.SetupForProver, "prove",
                        _first_again(fn) if fault == "unchanged" else _prove_altered(fn))
    out = run_tiny("tiny.backlog", seconds=1)
    assert out["attempted"] >= 1 and not out["correct"]
    assert out["checks"]["proofs_rejected"]["value"] == out["attempted"]


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_lagrange_key_faults(monkeypatch, fault):
    from plonkit_tpu_torch import api
    fn = api.crs_lagrange_form
    monkeypatch.setattr(api, "crs_lagrange_form",
                        _first_again(fn) if fault == "unchanged" else _key_altered(fn))
    # the warm-up derives key 0 first, so the first answer given again is
    # wrong from the window's second request on
    out = run_tiny("tiny_lagrange.keygen", seconds=20 if fault == "unchanged" else 1)
    assert out["attempted"] >= (2 if fault == "unchanged" else 1) and not out["correct"]
    assert out["checks"]["keys_refused"]["value"] > 0
