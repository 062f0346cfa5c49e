"""The harness end to end at the tiny cells, with the card's look left out:
a sound run is correct, and the control (the program's own path that
breaks one guarantee the configuration states: the rescue transcript for a
keccak prover, the key of half the domain for a Lagrange key) is not.  On
the card the same, marked cuda."""

import pytest

from conftest import run_tiny


@pytest.mark.parametrize("cell,count", [("tiny.backlog", "proofs_rejected"),
                                        ("tiny_lagrange.backlog", "proofs_rejected"),
                                        ("tiny_lagrange.keygen", "keys_refused")])
def test_sound_and_control(cell, count):
    sound = run_tiny(cell)
    assert sound["correct"] and sound["attempted"] >= 1 and sound["failed"] == 0
    assert list(sound)[-1] == "checks" and sound["checks"][count] == {"value": 0, "limit": 0}
    control = run_tiny(cell, control=True)
    assert not control["correct"]
    assert control["checks"][count]["value"] > control["checks"][count]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.backlog", "tiny_lagrange.keygen"])
def test_sound_and_control_on_the_card(card, cell):
    sound = run_tiny(cell, device=card, seconds=2)
    assert sound["correct"] and sound["device"]["platform"] == "gpu"
    assert not run_tiny(cell, device=card, seconds=2, control=True)["correct"]
