"""The port's Poseidon frontend against the JAX package's, exactly:
circomlib's test vectors, the Grain parameters, the hash, the R1CS emitter,
the 2^12 Poseidon chain of scripts/bench_prove.py and its CPU prove (vk and
proof bytes equal to plonkit_tpu's HostBackend), and a prove over a
foreign (random-tau) SRS.  A Poseidon hash transpiles to 2,308 gates, so
every prove here runs at a 2^12 domain."""

import io
import os
import random

import numpy as np
import pytest
import torch

from plonkit_tpu.api import SetupForProver as RefSetup, verify as ref_verify
from plonkit_tpu.backend import HostBackend
from plonkit_tpu.frontend import poseidon as ref_poseidon
from plonkit_tpu.serialization import (CrsHandle as RefCrsHandle, Proof as RefProof,
                                       VerificationKey as RefVk)
from plonkit_tpu_torch import native
from plonkit_tpu_torch.api import SetupForProver, analyse, gen_key_monomial_form, verify
from plonkit_tpu_torch.curve import G2_GEN, g2_mul
from plonkit_tpu_torch.fields import FR_MODULUS as P
from plonkit_tpu_torch.frontend.poseidon import (grain_parameters, poseidon,
                                                 poseidon_circuit)
from plonkit_tpu_torch.frontend.synthetic import poseidon_chain_circuit
from plonkit_tpu_torch.serialization import Crs, CrsHandle, Proof
from plonkit_tpu_torch.srs import dev_srs_g1
from scripts.bench_prove import poseidon_chain_circuit as ref_chain_circuit

LOG2 = 12


@pytest.fixture(autouse=True, scope="module")
def _env(tmp_path_factory):
    old_threads, old_build = torch.get_num_threads(), native.BUILD_DIR
    torch.set_num_threads(1)
    native.BUILD_DIR = str(tmp_path_factory.mktemp("native_build"))
    yield
    torch.set_num_threads(old_threads)
    native.BUILD_DIR = old_build


def test_circomlib_test_vectors():
    # circomlibjs test/poseidon.js
    assert poseidon([1, 2]) == \
        7853200120776062878684798364095072458815029376092732009249414926327459813530
    assert poseidon([1]) == \
        18586133768512220936620570745912940619677854269274689475585506675881198879027


def test_grain_parameter_anchors():
    # first round constant and MDS[0][0] of circomlib's t=3 tables
    C, M = grain_parameters(3)
    assert C[0] == 0x0EE9A592BA9A9518D05986D656F40C2114C4993C11BB29938D21D47304CD8E6E
    assert M[0][0] == 0x109B7F411BA0E4C9B2B70CAF5C36A7B194BE7C11AD24378BFEDB68592BA8118B
    assert len(C) == (8 + 57) * 3


@pytest.mark.parametrize("t", [2, 3, 4, 5])
def test_grain_parameters_match_jax_package(t):
    assert grain_parameters(t) == ref_poseidon.grain_parameters(t)


def test_hash_matches_jax_package():
    rng = np.random.default_rng(5)
    for width in (1, 2, 3, 4):
        for _ in range(3):
            inputs = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(width)]
            assert poseidon(inputs) == ref_poseidon.poseidon(inputs)


def test_circuit_matches_jax_package():
    circ, out = poseidon_circuit(2, chain=3)
    ref, ref_out = ref_poseidon.poseidon_circuit(2, chain=3)
    assert out == ref_out == poseidon([poseidon([poseidon([1, 2]), 1000]), 1001])
    assert circ.r1cs.constraints == ref.r1cs.constraints
    assert circ.witness == ref.witness
    assert (circ.r1cs.num_inputs, circ.r1cs.num_aux, circ.r1cs.num_variables) == \
        (ref.r1cs.num_inputs, ref.r1cs.num_aux, ref.r1cs.num_variables)
    for a, b, c in circ.r1cs.constraints:
        av, bv, cv = (sum(circ.witness[i] * v for i, v in lc) % P for lc in (a, b, c))
        assert av * bv % P == cv


@pytest.fixture(scope="module")
def chain():
    return poseidon_chain_circuit(LOG2)


def test_witness_limbs_match_jax_package(chain, tmp_path):
    """serialization.load_witness_limbs: the port's [N, 8] int32 rows hold
    the JAX package's [16, N] limbs of the chain's .wtns."""
    from plonkit_tpu.serialization import load_witness_limbs as ref_load_witness_limbs
    from plonkit_tpu_torch import convert
    from plonkit_tpu_torch.frontend.witness import write_witness_bin
    from plonkit_tpu_torch.serialization import load_witness_limbs
    path = str(tmp_path / "chain.wtns")
    write_witness_bin(chain.witness, path)
    rows = load_witness_limbs(path)
    assert rows.dtype == np.int32 and rows.shape == (len(chain.witness), 8)
    assert np.array_equal(convert.rows_to_limbs16(rows.view(np.uint32)),
                          ref_load_witness_limbs(path))
    weights = np.array([1 << (32 * k) for k in range(8)], dtype=object)
    assert list(rows.view(np.uint32).astype(object) @ weights) == chain.witness


def test_chain_circuit_matches_bench_prove(chain):
    ref = ref_chain_circuit(LOG2)
    assert chain.r1cs.constraints == ref.r1cs.constraints
    assert chain.witness == ref.witness
    assert analyse(chain).num_gates == 2308
    assert chain.r1cs.num_variables == ref.r1cs.num_variables


@pytest.fixture(scope="module")
def dev_key(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("srs") / f"srs_2pow{LOG2}.key")
    gen_key_monomial_form(LOG2).save(path)
    return path


@pytest.fixture(scope="module")
def dev_vk(chain, dev_key):
    return SetupForProver(chain, CrsHandle(dev_key), device="cpu").make_verification_key()


def test_chain_prove_matches_jax_host_backend(chain, dev_key, dev_vk):
    setup = SetupForProver(chain, CrsHandle(dev_key), device="cpu")
    proof = setup.prove(chain)
    assert verify(dev_vk, proof)
    ref = RefSetup(ref_chain_circuit(LOG2), RefCrsHandle(dev_key), backend=HostBackend())
    assert dev_vk.to_bytes() == ref.make_verification_key().to_bytes()
    assert proof.to_bytes() == ref.prove(ref_chain_circuit(LOG2)).to_bytes()


def test_foreign_srs_prove(chain, dev_vk, tmp_path):
    """A random-tau key from srs.py, written and reloaded through
    CrsHandle: the Poseidon proof verifies in both packages' verifiers and
    fails against the tau = 42 vk."""
    tau = random.Random(424242).randrange(2, P)
    n = 1 << LOG2
    path = os.path.join(tmp_path, "foreign.key")
    Crs(dev_srs_g1(n, tau), [G2_GEN, g2_mul(G2_GEN, tau)]).save(path)
    assert os.path.getsize(path) == 8 + n * 64 + 8 + 2 * 128
    handle = CrsHandle(path)
    assert handle.num_g1 == n and handle.g2_monomial_bases[1] == g2_mul(G2_GEN, tau)
    setup = SetupForProver(chain, handle, device="cpu")
    vk, proof = setup.make_verification_key(), setup.prove(chain)
    assert verify(vk, proof)
    assert proof.input_values == [chain.witness[1]]
    assert ref_verify(_ref(RefVk, vk.to_bytes()), _ref(RefProof, proof.to_bytes()))
    assert not verify(dev_vk, proof)
    tampered = _ref(Proof, proof.to_bytes())
    tampered.input_values = [(tampered.input_values[0] + 1) % P]
    assert not verify(vk, tampered)


def _ref(cls, blob: bytes):
    """A key or proof read back from its bytes by either package's class."""
    return cls.read(io.BytesIO(blob))
