"""The inner proofs past the fixture's pair, on the CPU: the third of the
reference's three-proof recursive workload and the third to fifth of the
five-proof one:

- scripts/gen_inner_circuit.py DIR 5 writes the circuit and the two
  witnesses of the in-repo fixture scratch/recursive_r22 byte for byte, and
  witness_2, witness_3 and witness_4, whose public inputs differ from
  every other witness's;
- the port's `prove(..., "rescue")` of witness_2, witness_3 and witness_4
  gives the bytes of the JAX package's prove of it (HostBackend, the same
  first 2^10 points of the tau = 42 key, each package reading the key and
  the files with its own loaders); both packages' verifiers accept it and
  reject a tampered copy.

tests/test_torch_recursive.py aggregates the third with the fixture's two
proofs, tests/test_torch_recursive_five.py all three.
"""

import io
import json
import os
import subprocess
import sys

import pytest
import torch

from plonkit_tpu.api import SetupForProver as RefSetupForProver
from plonkit_tpu.api import verify as ref_verify
from plonkit_tpu.backend import HostBackend
from plonkit_tpu.frontend import CircomCircuit as RefCircuit
from plonkit_tpu.frontend import load_r1cs as ref_load_r1cs
from plonkit_tpu.frontend import load_witness as ref_load_witness
from plonkit_tpu.serialization import Proof as RefProof
from plonkit_tpu.serialization import VerificationKey as RefVerificationKey
from plonkit_tpu_torch import native
from plonkit_tpu_torch.api import SetupForProver, verify
from plonkit_tpu_torch.fields import FR_MODULUS as R
from plonkit_tpu_torch.frontend import CircomCircuit, load_r1cs, load_witness
from plonkit_tpu_torch.serialization import CrsHandle, Proof, VerificationKey

from test_torch_prove import KEY, ref_crs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R22 = os.path.join(REPO, "scratch", "recursive_r22")
GENERATOR = os.path.join(REPO, "scripts", "gen_inner_circuit.py")
PROOFS = 5
INNER = (2, 3, 4)           # the witnesses past the fixture's pair


def generate(directory) -> str:
    """gen_inner_circuit.py's circuit and PROOFS witnesses into directory."""
    subprocess.run([sys.executable, GENERATOR, str(directory), str(PROOFS)], check=True,
                   capture_output=True, timeout=120)
    return str(directory)


def port_rescue_proof(directory, index: int) -> Proof:
    """The port's rescue prove of witness_<index>.json on the CPU."""
    r1cs = load_r1cs(os.path.join(directory, "circuit.r1cs.json"))
    setup = SetupForProver(CircomCircuit(r1cs=r1cs), CrsHandle(KEY), device="cpu")
    return setup.prove(CircomCircuit(r1cs=r1cs, witness=load_witness(
        os.path.join(directory, f"witness_{index}.json"))), "rescue")


@pytest.fixture(autouse=True, scope="module")
def _env(tmp_path_factory):
    old_threads, old_build = torch.get_num_threads(), native.BUILD_DIR
    torch.set_num_threads(1)
    native.BUILD_DIR = str(tmp_path_factory.mktemp("native_build"))
    yield
    torch.set_num_threads(old_threads)
    native.BUILD_DIR = old_build


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    return generate(tmp_path_factory.mktemp("inner"))


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", ["circuit.r1cs.json", "witness_0.json", "witness_1.json"])
def test_generator_writes_the_fixture(generated, name):
    assert _read(os.path.join(generated, name)) == _read(os.path.join(R22, name))


@pytest.mark.parametrize("index", INNER, ids=[f"witness_{i}" for i in INNER])
def test_third_witness_is_distinct(generated, index):
    with open(os.path.join(generated, f"witness_{index}.json")) as f:
        third = json.load(f)
    for i in range(PROOFS):
        if i == index:
            continue
        with open(os.path.join(generated, f"witness_{i}.json")) as f:
            other = json.load(f)
        assert len(third) == len(other)
        assert third[0] == other[0] == "1"
        assert third[1:3] != other[1:3]         # the two public inputs


@pytest.fixture(scope="module")
def ref_setup(generated):
    """(the JAX package's setup of the circuit, its r1cs)."""
    rc = RefCircuit(r1cs=ref_load_r1cs(os.path.join(generated, "circuit.r1cs.json")))
    return RefSetupForProver(rc, ref_crs(KEY, 1 << 10), backend=HostBackend()), rc.r1cs


@pytest.fixture(scope="module", params=INNER, ids=[f"witness_{i}" for i in INNER])
def third(request, generated, ref_setup):
    """(the port's proof, the JAX package's proof) of witness_<i>.json."""
    setup, r1cs = ref_setup
    port = port_rescue_proof(generated, request.param)
    ref = setup.prove(RefCircuit(r1cs=r1cs, witness=ref_load_witness(
        os.path.join(generated, f"witness_{request.param}.json"))), "rescue")
    return port, ref


def test_third_proof_bytes_match_reference(third):
    port, ref = third
    assert port.to_bytes() == ref.to_bytes()
    for i in (0, 1):
        assert port.to_bytes() != _read(os.path.join(R22, f"proof_{i}.bin"))


def test_third_proof_verifies_in_both_packages(third):
    port, _ = third
    vk = VerificationKey.load(os.path.join(R22, "vk.bin"))
    ref_vk = RefVerificationKey.load(os.path.join(R22, "vk.bin"))
    ref_proof = RefProof.read(io.BytesIO(port.to_bytes()))
    assert verify(vk, port, "rescue")
    assert ref_verify(ref_vk, ref_proof, "rescue")
    assert not verify(vk, port, "keccak")
    tampered = Proof.read(io.BytesIO(port.to_bytes()))
    tampered.wire_values_at_z[0] = (tampered.wire_values_at_z[0] + 1) % R
    assert not verify(vk, tampered, "rescue")
    assert not ref_verify(ref_vk, RefProof.read(io.BytesIO(tampered.to_bytes())), "rescue")
