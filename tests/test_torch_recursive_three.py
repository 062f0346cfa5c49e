"""The third inner proof of the reference's three-proof recursive workload,
on the CPU:

- scripts/gen_inner_circuit.py DIR 3 writes the circuit and the two
  witnesses of the in-repo fixture scratch/recursive_r22 byte for byte, and
  a third witness that differs from both;
- the port's `prove(..., "rescue")` of that witness gives the bytes of the
  JAX package's prove of it (HostBackend, the same first 2^10 points of the
  tau = 42 key, each package reading the key and the files with its own
  loaders); both packages' verifiers accept it and reject a tampered copy.

tests/test_torch_recursive.py aggregates it with the fixture's two proofs.
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
PROOFS = 3


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


def test_third_witness_is_distinct(generated):
    with open(os.path.join(generated, "witness_2.json")) as f:
        third = json.load(f)
    for i in (0, 1):
        with open(os.path.join(R22, f"witness_{i}.json")) as f:
            other = json.load(f)
        assert len(third) == len(other)
        assert third[0] == other[0] == "1"
        assert third[1:3] != other[1:3]         # the two public inputs


@pytest.fixture(scope="module")
def third(generated):
    """(the port's proof, the JAX package's proof) of witness_2.json."""
    port = port_rescue_proof(generated, 2)
    rc = RefCircuit(r1cs=ref_load_r1cs(os.path.join(generated, "circuit.r1cs.json")))
    ref_setup = RefSetupForProver(rc, ref_crs(KEY, 1 << 10), backend=HostBackend())
    ref = ref_setup.prove(RefCircuit(r1cs=rc.r1cs, witness=ref_load_witness(
        os.path.join(generated, "witness_2.json"))), "rescue")
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
