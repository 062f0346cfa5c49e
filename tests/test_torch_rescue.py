"""The port's rescue hash and transcript (plonkit_tpu_torch/recursive/
{franklin,rescue}.py, transcript.make_transcript("rescue")) against the JAX
package's on seeded inputs, and `prove -t rescue` / `verify -t rescue` of
the port on the in-repo circuit scratch/recursive_r22 (domain 64, the
first 2^10 points of the in-repo tau = 42 key): the proofs equal the JAX
package's proof_0.bin and proof_1.bin byte for byte."""

import os

import numpy as np
import pytest
import torch

from plonkit_tpu.recursive import franklin as ref_franklin
from plonkit_tpu.recursive import rescue as ref_rescue
from plonkit_tpu.transcript import make_transcript as ref_make_transcript
from plonkit_tpu_torch import cli, native
from plonkit_tpu_torch.api import SetupForProver, verify
from plonkit_tpu_torch.curve import G1_GEN, g1_mul
from plonkit_tpu_torch.fields import FQ_MODULUS, FR_MODULUS as R
from plonkit_tpu_torch.frontend import CircomCircuit, load_r1cs, load_witness
from plonkit_tpu_torch.recursive import franklin, rescue
from plonkit_tpu_torch.serialization import CrsHandle, Proof, VerificationKey
from plonkit_tpu_torch.transcript import make_transcript

from test_torch_prove import KEY

SEED = 20241017
FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scratch", "recursive_r22")


@pytest.fixture(autouse=True, scope="module")
def _env(tmp_path_factory):
    old_threads, old_build = torch.get_num_threads(), native.BUILD_DIR
    torch.set_num_threads(1)
    native.BUILD_DIR = str(tmp_path_factory.mktemp("native_build"))
    yield
    torch.set_num_threads(old_threads)
    native.BUILD_DIR = old_build


def _fr(rng, count):
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(count)]


def test_parameters_equal():
    assert franklin.ROUND_CONSTANTS == ref_franklin.ROUND_CONSTANTS
    assert franklin.MDS == ref_franklin.MDS
    assert (franklin.ALPHA, franklin.ALPHA_INV) == (ref_franklin.ALPHA, ref_franklin.ALPHA_INV)


@pytest.mark.parametrize("length", [1, 2, 3, 7, 20])
def test_rescue_hash_equal(length):
    rng = np.random.default_rng(SEED + length)
    inputs = _fr(rng, length)
    assert rescue.rescue_hash(inputs) == ref_rescue.rescue_hash(inputs)


def test_rescue_mimc_equal():
    rng = np.random.default_rng(SEED)
    for _ in range(4):
        state = _fr(rng, 3)
        assert franklin.rescue_mimc(list(state)) == ref_franklin.rescue_mimc(list(state))
        assert rescue.rescue_permutation(state) == ref_rescue.rescue_permutation(state)


def test_rescue_transcript_challenges_equal():
    rng = np.random.default_rng(SEED)
    port, ref = make_transcript("rescue"), ref_make_transcript("rescue")
    assert isinstance(port, rescue.RescueTranscript)
    challenges, ref_challenges = [], []
    for step in range(6):
        for x in _fr(rng, step + 1):
            port.update_fr(x)
            ref.update_fr(x)
        k = int.from_bytes(rng.bytes(32), "little") % R
        p = None if step == 3 else g1_mul(G1_GEN, k)
        port.update_g1(p)
        ref.update_g1(p)
        port.update_u256(k % FQ_MODULUS)
        ref.update_u256(k % FQ_MODULUS)
        challenges.append(port.get_challenge())
        ref_challenges.append(ref.get_challenge())
    assert challenges == ref_challenges


@pytest.fixture(scope="module")
def r1cs():
    return load_r1cs(os.path.join(FIXTURES, "circuit.r1cs.json"))


@pytest.fixture(scope="module")
def setup(r1cs):
    return SetupForProver(CircomCircuit(r1cs=r1cs), CrsHandle(KEY), device="cpu")


@pytest.mark.parametrize("index", [0, 1])
def test_rescue_prove_equals_fixture(r1cs, setup, index):
    circuit = CircomCircuit(r1cs=r1cs, witness=load_witness(
        os.path.join(FIXTURES, f"witness_{index}.json")))
    proof = setup.prove(circuit, "rescue")
    with open(os.path.join(FIXTURES, f"proof_{index}.bin"), "rb") as f:
        assert proof.to_bytes() == f.read()
    vk = VerificationKey.load(os.path.join(FIXTURES, "vk.bin"))
    assert verify(vk, proof, "rescue")
    assert not verify(vk, proof, "keccak")


def test_rescue_verify_cli(tmp_path):
    """verify -t rescue through the port's CLI: 0 on the fixture's proofs,
    400 on a tampered one and on a rescue proof checked as keccak."""
    vk = os.path.join(FIXTURES, "vk.bin")
    for index in (0, 1):
        cli.main(["--backend", "cpu", "verify", "-p", os.path.join(FIXTURES, f"proof_{index}.bin"),
                  "-v", vk, "-t", "rescue"])
    proof = Proof.load(os.path.join(FIXTURES, "proof_0.bin"))
    proof.wire_values_at_z[1] = (proof.wire_values_at_z[1] + 1) % R
    tampered = tmp_path / "tampered.bin"
    proof.save(str(tampered))
    for path, transcript in ((str(tampered), "rescue"),
                             (os.path.join(FIXTURES, "proof_0.bin"), "keccak")):
        with pytest.raises(SystemExit) as exc:
            cli.main(["--backend", "cpu", "verify", "-p", path, "-v", vk, "-t", transcript])
        assert exc.value.code == 400


def test_rescue_prove_cli(tmp_path, monkeypatch):
    """prove -t rescue through the port's CLI writes proof_0.bin's bytes."""
    monkeypatch.chdir(tmp_path)
    cli.main(["--backend", "cpu", "setup", "-p", "10", "-m", "setup.key"])
    cli.main(["--backend", "cpu", "prove", "-m", "setup.key", "-c",
              os.path.join(FIXTURES, "circuit.r1cs.json"), "-w",
              os.path.join(FIXTURES, "witness_0.json"), "-t", "rescue"])
    with open("proof.bin", "rb") as f, open(os.path.join(FIXTURES, "proof_0.bin"), "rb") as g:
        assert f.read() == g.read()
