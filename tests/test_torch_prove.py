"""The port's whole slice on the CPU: make_verification_key and prove on a
2^10-domain synthetic circuit give vk.bin and proof.bin bytes identical to
plonkit_tpu's HostBackend on the same circuit and the same SRS (the first
2^10 points of the repository's tau = 42 key, each package reading it with
its own loader), and the port's verifier accepts the proof and rejects a
tampered one."""

import io
import os

import numpy as np
import pytest
import torch

from plonkit_tpu.api import SetupForProver as RefSetupForProver
from plonkit_tpu.backend import HostBackend
from plonkit_tpu.curve import G1_GEN, G2_GEN, g1_mul, g2_mul
from plonkit_tpu.fields import FR_MODULUS as R
from plonkit_tpu.frontend.circuit import CircomCircuit as RefCircuit
from plonkit_tpu.frontend.r1cs import R1CS as RefR1CS
from plonkit_tpu.plonk.verifier import verify as ref_verify
from plonkit_tpu.serialization import Crs as RefCrs
from plonkit_tpu.serialization import CrsHandle as RefCrsHandle
from plonkit_tpu.serialization import load_crs_g1_limbs as ref_load_crs_g1_limbs
from plonkit_tpu.serialization import Proof as RefProof
from plonkit_tpu.serialization import VerificationKey as RefVerificationKey
from plonkit_tpu_torch import native
from plonkit_tpu_torch.api import SetupForProver, gen_key_monomial_form, verify
from plonkit_tpu_torch.frontend.synthetic import synth_circuit
from plonkit_tpu_torch.serialization import CrsHandle, Proof, load_crs_g1_limbs

LOG2 = 10
# the tau = 42 dev SRS of 2^22 points, made by `python -m plonkit_tpu setup -p 22`
KEY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "scratch", "recursive_r22", "srs_2pow22.key")


@pytest.fixture(autouse=True, scope="module")
def _env(tmp_path_factory):
    old_threads, old_build = torch.get_num_threads(), native.BUILD_DIR
    torch.set_num_threads(1)
    native.BUILD_DIR = str(tmp_path_factory.mktemp("native_build"))
    yield
    torch.set_num_threads(old_threads)
    native.BUILD_DIR = old_build


def ref_crs(path, count):
    """The first `count` G1 points and the G2 pair, read with the JAX
    package's own loaders."""
    x, y, inf = ref_load_crs_g1_limbs(path, count)
    weights = [1 << (16 * k) for k in range(16)]

    def ints(planar):
        return [sum(int(v) * w for v, w in zip(col, weights)) for col in planar.T]
    points = [None if i else p for p, i in zip(zip(ints(x), ints(y)), inf)]
    return RefCrs(points, RefCrsHandle(path).g2_monomial_bases)


def ref_circuit(port_circuit):
    """The same R1CS and witness as the JAX package's objects."""
    r = port_circuit.r1cs
    return RefCircuit(r1cs=RefR1CS(num_inputs=r.num_inputs, num_aux=r.num_aux,
                                   num_variables=r.num_variables,
                                   constraints=r.constraints),
                      witness=list(port_circuit.witness))


@pytest.fixture(scope="module")
def proofs():
    circuit = synth_circuit(LOG2 - 1)
    port = SetupForProver(circuit, CrsHandle(KEY), device="cpu")
    assert port.setup_polynomials.domain_size == 1 << LOG2
    port_vk, port_proof = port.make_verification_key(), port.prove(circuit)
    rc = ref_circuit(circuit)
    ref = RefSetupForProver(rc, ref_crs(KEY, 1 << LOG2), backend=HostBackend())
    return port_vk, port_proof, ref.make_verification_key(), ref.prove(rc)


def test_dev_srs_matches_reference_points():
    """The SRS the port generates (chip_smoke.py proves over it) is the
    repository's key, point for point, and both loaders read the key alike."""
    crs = ref_crs(KEY, 1 << LOG2)
    assert len(crs.g1_bases) == 1 << LOG2
    for i in (0, 1, 2, 3, 517, (1 << LOG2) - 1):
        assert crs.g1_bases[i] == g1_mul(G1_GEN, pow(42, i, R)), i
    assert crs.g2_monomial_bases == [G2_GEN, g2_mul(G2_GEN, 42)]
    gen = gen_key_monomial_form(LOG2)
    assert gen.g1_bases == crs.g1_bases
    assert gen.g2_monomial_bases == crs.g2_monomial_bases
    x, y, inf = load_crs_g1_limbs(KEY, 1 << LOG2)
    gx, gy = (np.array([p[k] for p in crs.g1_bases], dtype=object) for k in (0, 1))
    weights = np.array([1 << (32 * k) for k in range(8)], dtype=object)
    assert not inf.any()
    assert list(x.astype(object) @ weights) == list(gx)
    assert list(y.astype(object) @ weights) == list(gy)


def test_vk_bytes_match_host_backend(proofs):
    port_vk, _, ref_vk, _ = proofs
    assert port_vk.to_bytes() == ref_vk.to_bytes()


def test_proof_bytes_match_host_backend(proofs):
    _, port_proof, _, ref_proof = proofs
    assert port_proof.to_bytes() == ref_proof.to_bytes()


def test_port_verifier_accepts_and_rejects(proofs):
    port_vk, port_proof, _, _ = proofs
    assert verify(port_vk, port_proof)
    tampered = Proof.read(io.BytesIO(port_proof.to_bytes()))
    tampered.linearization_polynomial_at_z = (tampered.linearization_polynomial_at_z + 1) % R
    assert not verify(port_vk, tampered)


def test_reference_verifier_accepts_port_proof(proofs):
    port_vk, port_proof, _, _ = proofs
    vk = RefVerificationKey.read(io.BytesIO(port_vk.to_bytes()))
    proof = RefProof.read(io.BytesIO(port_proof.to_bytes()))
    assert ref_verify(vk, proof)
