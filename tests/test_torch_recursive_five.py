"""The five-proof aggregation circuit of the port against the JAX package's,
on the CPU: 4,395,827 gates, the first proof count whose circuit needs a
2^23 domain (the prover's LDEs are then 2^25-point transforms, which the
port splits into four 2^23-point ones).

- the circuit of scratch/recursive_r22's two proofs and of the rescue
  proofs of gen_inner_circuit.py's witness_2 ... witness_4 (made by the
  port on the CPU; tests/test_torch_recursive_three.py holds their bytes
  against the JAX package's) has the same gates, wires, selectors,
  witness, limbs and public inputs in both packages;
- make_recursive_vk(num_proofs=5)'s dummy-proof circuit, which
  export-recursive-verification-key -c 5 runs, is the JAX package's too,
  and has the gates of the circuit of the five real proofs.

Each circuit is built once, reduced to digests of its parts and dropped
before the next is built, so that the worker holds one 4.4 M-gate circuit
at a time.
"""

import functools
import hashlib
import io
import os
import pickle
import tempfile

import pytest
import torch

import plonkit_tpu.recursive.aggregation as ref_aggregation
import plonkit_tpu.serialization as ref_serialization
from plonkit_tpu_torch import native
from plonkit_tpu_torch.plonk.extended import domain_size_for_gates
from plonkit_tpu_torch.recursive import aggregation
from plonkit_tpu_torch.serialization import Proof, VerificationKey

from test_torch_recursive import _recursive_vk_circuit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R22 = os.path.join(REPO, "scratch", "recursive_r22")
INNER = (2, 3, 4)           # gen_inner_circuit.py's witnesses past the fixture's pair
GATES = 4_395_827
VARIABLES = 10_519_957
DOMAIN = 1 << 23
CHUNK = 1 << 16             # list items hashed a pickle at a time


@pytest.fixture(autouse=True, scope="module")
def _env(tmp_path_factory):
    old_threads, old_build = torch.get_num_threads(), native.BUILD_DIR
    torch.set_num_threads(1)
    native.BUILD_DIR = str(tmp_path_factory.mktemp("native_build"))
    yield
    torch.set_num_threads(old_threads)
    native.BUILD_DIR = old_build


@functools.lru_cache(maxsize=None)
def _inner_proof_bytes() -> dict:
    """The port's rescue proofs of witness_2 ... witness_4 on the CPU."""
    from test_torch_recursive_three import generate, port_rescue_proof
    with tempfile.TemporaryDirectory() as d:
        generate(d)
        return {i: port_rescue_proof(d, i).to_bytes() for i in INNER}


def _proofs(proof_cls) -> list:
    return ([proof_cls.load(os.path.join(R22, f"proof_{i}.bin")) for i in (0, 1)]
            + [proof_cls.read(io.BytesIO(_inner_proof_bytes()[i])) for i in INNER])


def _list_digest(items) -> str:
    h = hashlib.sha256()
    for i in range(0, len(items), CHUNK):
        h.update(pickle.dumps(items[i:i + CHUNK]))
    return h.hexdigest()


def _summary(c) -> dict:
    """What the tests compare of a circuit, without the circuit."""
    return {"num_gates": c.num_gates, "variables": len(c.values),
            "domain": domain_size_for_gates(len(c.input_vars) + c.num_gates),
            "wires": _list_digest(c.wires), "sels": _list_digest(c.sels),
            "input_vars": _list_digest(c.input_vars), "values": _list_digest(c.values),
            "public_inputs": c.public_inputs()}


@pytest.fixture(scope="module")
def circuits():
    """{package: (summary, limbs)} of the circuit of the five proofs."""
    out = {}
    c, limbs = aggregation.build_aggregation_circuit(
        VerificationKey.load(os.path.join(R22, "vk.bin")), _proofs(Proof))
    out["port"] = _summary(c), limbs
    del c
    c, limbs = ref_aggregation.build_aggregation_circuit(
        ref_serialization.VerificationKey.load(os.path.join(R22, "vk.bin")),
        _proofs(ref_serialization.Proof))
    out["jax"] = _summary(c), limbs
    del c
    return out


@pytest.fixture(scope="module")
def vk_circuits():
    """{package: summary} of make_recursive_vk(num_proofs=5)'s circuit."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, module, vk_cls in (("port", aggregation, VerificationKey),
                                     ("jax", ref_aggregation, ref_serialization.VerificationKey)):
            c = _recursive_vk_circuit(module, mp, vk_cls.load(os.path.join(R22, "vk.bin")), 5)
            out[name] = _summary(c)
            del c
    finally:
        mp.undo()
    return out


def test_five_proof_circuit_size(circuits):
    summary, _ = circuits["port"]
    assert summary["num_gates"] == GATES
    assert summary["variables"] == VARIABLES
    assert summary["domain"] == DOMAIN
    assert len(summary["public_inputs"]) == 1


@pytest.mark.parametrize("part", ["num_gates", "variables", "domain", "wires", "sels",
                                  "input_vars", "values", "public_inputs"])
def test_five_proof_circuit_matches_reference(circuits, part):
    assert circuits["port"][0][part] == circuits["jax"][0][part]


def test_five_proof_limbs_match_reference(circuits):
    assert circuits["port"][1] == circuits["jax"][1]


@pytest.mark.parametrize("part", ["num_gates", "variables", "domain", "wires", "sels",
                                  "input_vars", "values"])
def test_recursive_vk_circuit_of_five_proofs_matches_reference(vk_circuits, part):
    """export-recursive-verification-key -c 5's circuit, witness included."""
    assert vk_circuits["port"][part] == vk_circuits["jax"][part]


@pytest.mark.parametrize("part", ["num_gates", "domain", "wires", "sels", "input_vars"])
def test_recursive_vk_circuit_has_the_gates_of_the_five_proofs(circuits, vk_circuits, part):
    """The dummy proofs give the real proofs' gates: the -c 5 vk verifies
    the aggregate of phase 10 of chip_smoke.py."""
    assert vk_circuits["port"][part] == circuits["port"][0][part]
