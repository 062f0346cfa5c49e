"""The port's recursive package (plonkit_tpu_torch/recursive/) against the
JAX package's on the CPU:

- each gadget (nonnative, ec_gadget, rescue_gadget) built from seeded
  inputs through each package's own modules gives the same output values,
  gate count, wires, selectors and witness; rns and vk_tree give the same
  values;
- the aggregation circuit of the in-repo fixture scratch/recursive_r5 (one
  rescue proof of the domain-64 circuit) has the same 1,611,923 gates,
  wires, selectors, witness and public input in both packages; so do the
  circuits of scratch/recursive_r22's two proofs (2,307,899 gates) and of
  those two with a third (3,003,875 gates, still a 2^22 domain: the
  reference's three-proof workload), and make_recursive_vk's dummy-proof
  circuit of three proofs has the gates of the three real proofs;
- off-circuit batched verification and the host aggregate of the
  fixture scratch/recursive_r22's proofs.

tests/test_torch_aggregation.py holds the fixture's aggregate and the
recursive CLI.
"""

import functools
import hashlib
import io
import os
import pickle
import random
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import plonkit_tpu.recursive.aggregation as ref_aggregation
import plonkit_tpu.recursive.batch as ref_batch
import plonkit_tpu.recursive.cs as ref_cs
import plonkit_tpu.recursive.ec_gadget as ref_ec_gadget
import plonkit_tpu.recursive.nonnative as ref_nonnative
import plonkit_tpu.recursive.rescue as ref_rescue
import plonkit_tpu.recursive.rescue_gadget as ref_rescue_gadget
import plonkit_tpu.recursive.rns as ref_rns
import plonkit_tpu.recursive.vk_tree as ref_vk_tree
import plonkit_tpu.serialization as ref_serialization
from plonkit_tpu_torch import native
from plonkit_tpu_torch.curve import G1_GEN, g1_mul
from plonkit_tpu_torch.fields import FQ_MODULUS as P, FR_MODULUS as R
from plonkit_tpu_torch.plonk.extended import domain_size_for_gates, validate_witness2
from plonkit_tpu_torch.recursive import (aggregation, batch, cs, ec_gadget, nonnative, rescue,
                                         rescue_gadget, rns, vk_tree)
from plonkit_tpu_torch.serialization import Proof, VerificationKey

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5 = os.path.join(REPO, "scratch", "recursive_r5")
R22 = os.path.join(REPO, "scratch", "recursive_r22")
SEED = 20241017

PORT = SimpleNamespace(cs=cs, nonnative=nonnative, ec_gadget=ec_gadget, rescue=rescue,
                       rescue_gadget=rescue_gadget, vk_tree=vk_tree)
REF = SimpleNamespace(cs=ref_cs, nonnative=ref_nonnative, ec_gadget=ref_ec_gadget,
                      rescue=ref_rescue, rescue_gadget=ref_rescue_gadget, vk_tree=ref_vk_tree)


@pytest.fixture(autouse=True, scope="module")
def _env(tmp_path_factory):
    old_threads, old_build = torch.get_num_threads(), native.BUILD_DIR
    torch.set_num_threads(1)
    native.BUILD_DIR = str(tmp_path_factory.mktemp("native_build"))
    yield
    torch.set_num_threads(old_threads)
    native.BUILD_DIR = old_build


def _structure(c):
    return (c.num_gates, c.wires, c.sels, c.values, c.input_vars)


# -- gadgets -----------------------------------------------------------------

def _nonnative_gadget(m):
    rng = random.Random(SEED)
    c = m.cs.CsBuilder()
    nn = m.nonnative
    a_v, b_v, x_v = (rng.randrange(P) for _ in range(3))
    a, b, x = nn.fq_alloc(c, a_v), nn.fq_alloc(c, b_v), nn.fq_alloc(c, x_v)
    prod = nn.fq_mul(c, a, b)
    s = nn.fq_sub(c, nn.fq_add(c, prod, x), nn.fq_scale(c, nn.fq_neg(c, b), 3))
    y = nn.fq_alloc(c, (a_v * b_v + x_v) % P)
    nn.fq_mul(c, a, b, expected=nn.fq_sub(c, y, x))
    nn.fq_enforce_equal(c, nn.fq_constant(c, s.value % P), s)
    return c, [prod.value, s.value]


def _ec_gadget(m):
    rng = random.Random(SEED)
    c = m.cs.CsBuilder()
    eg = m.ec_gadget
    pts = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(3)]
    scalars = [rng.randrange(1 << 16) for _ in range(3)]
    p, q = eg.point_alloc(c, pts[0]), eg.point_alloc(c, pts[1])
    outs = [eg.ec_add(c, p, q), eg.ec_double(c, p), eg.ec_neg(c, q)]
    pairs = [(eg.point_alloc(c, pt), c.alloc(s)) for pt, s in zip(pts, scalars)]
    outs.append(eg.ec_msm(c, pairs, width=16))
    return c, [o.point for o in outs]


def _rescue_gadget(m):
    rng = random.Random(SEED)
    c = m.cs.CsBuilder()
    rg = m.rescue_gadget
    inputs = [rng.randrange(R) for _ in range(5)]
    h = rg.rescue_hash_gadget(c, [c.alloc(v) for v in inputs])
    t = rg.RescueTranscriptGadget(c)
    challenges = []
    for v in inputs:
        t.update_fr(c.alloc(v))
        challenges.append(t.get_challenge().value)
    leaves = [m.rescue.rescue_hash([i, i + 1]) for i in range(8)]
    levels = [leaves]
    while len(levels[-1]) > 1:
        cur = levels[-1]
        levels.append([m.rescue.rescue_hash([cur[i], cur[i + 1]])
                       for i in range(0, len(cur), 2)])
    leaf, path = m.vk_tree.merkle_query(levels, 5)
    bits = [c.alloc((5 >> i) & 1) for i in range(len(path))]
    rg.merkle_verify_gadget(c, c.alloc(leaf), bits, [c.alloc(v) for v in path],
                            c.alloc(levels[-1][0]))
    return c, [h.value, challenges, m.rescue.rescue_hash(inputs)]


@pytest.mark.parametrize("build", [_nonnative_gadget, _ec_gadget, _rescue_gadget],
                         ids=["nonnative", "ec_gadget", "rescue_gadget"])
def test_gadget_matches_reference(build):
    c, outs = build(PORT)
    ref_c, ref_outs = build(REF)
    assert outs == ref_outs
    assert _structure(c) == _structure(ref_c)
    validate_witness2(c.setup(), c.wire_columns(), c.public_inputs())


def test_rns_matches_reference():
    rng = np.random.default_rng(SEED)
    for _ in range(8):
        x = int.from_bytes(rng.bytes(32), "little") % P
        assert rns.fq_to_limbs(x) == ref_rns.fq_to_limbs(x)
        assert rns.fq_to_double_limbs(x) == ref_rns.fq_to_double_limbs(x)
        assert rns.limbs_to_fq(rns.fq_to_limbs(x)) == x
        assert rns.double_limbs_to_fq(rns.fq_to_double_limbs(x)) == x


def test_vk_tree_matches_reference():
    vk = VerificationKey.load(os.path.join(R22, "vk.bin"))
    ref_vk = ref_serialization.VerificationKey.load(os.path.join(R22, "vk.bin"))
    assert vk_tree.vk_leaf_encoding(vk) == ref_vk_tree.vk_leaf_encoding(ref_vk)
    assert vk_tree.build_vk_tree([vk]) == ref_vk_tree.build_vk_tree([ref_vk])
    assert vk_tree.get_vk_tree_root_hash(vk) == ref_vk_tree.get_vk_tree_root_hash(ref_vk)


def test_rescue_aggregate_matches_reference():
    """The per-proof challenge and the aggregated pair of the fixture's two
    rescue proofs; an invalid proof makes the aggregate None."""
    vk = VerificationKey.load(os.path.join(R22, "vk.bin"))
    proofs = [Proof.load(os.path.join(R22, f"proof_{i}.bin")) for i in (0, 1)]
    ref_vk = ref_serialization.VerificationKey.load(os.path.join(R22, "vk.bin"))
    ref_proofs = [ref_serialization.Proof.load(os.path.join(R22, f"proof_{i}.bin"))
                  for i in (0, 1)]
    assert aggregation.derive_rho(vk, proofs[0]) == \
        ref_aggregation.derive_rho(ref_vk, ref_proofs[0])
    agg = aggregation.compute_aggregate(vk, proofs)
    assert agg is not None
    assert agg == ref_aggregation.compute_aggregate(ref_vk, ref_proofs)
    assert aggregation.expected_aggregated_input(vk, proofs) == \
        ref_aggregation.expected_aggregated_input(ref_vk, ref_proofs)
    bad = Proof.read(io.BytesIO(proofs[1].to_bytes()))
    bad.wire_values_at_z[0] = (bad.wire_values_at_z[0] + 1) % R
    assert aggregation.compute_aggregate(vk, [proofs[0], bad]) is None


def test_batch_verify_matches_reference():
    """Off-circuit batched verification (one pairing for N keccak proofs) of
    the fixture's two witnesses, proved here by the port."""
    from plonkit_tpu_torch.api import SetupForProver
    from plonkit_tpu_torch.frontend import CircomCircuit, load_r1cs, load_witness
    from plonkit_tpu_torch.serialization import CrsHandle
    from test_torch_prove import KEY
    r1cs = load_r1cs(os.path.join(R22, "circuit.r1cs.json"))
    setup = SetupForProver(CircomCircuit(r1cs=r1cs), CrsHandle(KEY), device="cpu")
    vk = VerificationKey.load(os.path.join(R22, "vk.bin"))
    proofs = [setup.prove(CircomCircuit(r1cs=r1cs, witness=load_witness(
        os.path.join(R22, f"witness_{i}.json")))) for i in (0, 1)]
    ref_vk = ref_serialization.VerificationKey.load(os.path.join(R22, "vk.bin"))
    ref_proofs = [ref_serialization.Proof.read(io.BytesIO(p.to_bytes())) for p in proofs]
    assert batch.aggregate_proofs(vk, proofs) == ref_batch.aggregate_proofs(ref_vk, ref_proofs)
    assert batch.verify_batch(vk, proofs)
    bad = Proof.read(io.BytesIO(proofs[1].to_bytes()))
    bad.wire_values_at_z[0] = (bad.wire_values_at_z[0] + 1) % R
    assert not batch.verify_batch(vk, [proofs[0], bad])


# -- the aggregation circuits of the fixtures ------------------------------------

THIRD = "third"    # the port's rescue proof of gen_inner_circuit.py's witness_2.json
_GATES = {}        # the gate digest of the three-proof circuit, once built


@functools.lru_cache(maxsize=None)
def _third_proof_bytes() -> bytes:
    from test_torch_recursive_three import generate, port_rescue_proof
    with tempfile.TemporaryDirectory() as d:
        return port_rescue_proof(generate(d), 2).to_bytes()


def _load_proofs(proof_cls, fixture, names):
    return [proof_cls.read(io.BytesIO(_third_proof_bytes())) if name == THIRD
            else proof_cls.load(os.path.join(fixture, name)) for name in names]


def _domain(c) -> int:
    return domain_size_for_gates(len(c.input_vars) + c.num_gates)


def _gate_digest(c) -> str:
    """sha256 of the circuit's gates (wires, selectors, input variables),
    which its witness does not change."""
    return hashlib.sha256(pickle.dumps((c.wires, c.sels, c.input_vars))).hexdigest()


@pytest.mark.parametrize("fixture,proofs,gates,variables", [
    (R5, ["proof_0.bin"], 1_611_923, 3_923_821),
    (R22, ["proof_0.bin", "proof_1.bin"], 2_307_899, 5_572_855),
    (R22, ["proof_0.bin", "proof_1.bin", THIRD], 3_003_875, 7_221_889),
], ids=["one_proof_2pow21", "two_proofs_2pow22", "three_proofs_2pow22"])
def test_aggregation_circuit_matches_reference_at_full_size(fixture, proofs, gates, variables):
    """The circuit of scratch/recursive_r5 (one rescue proof; its aggregate
    is in the fixture), of scratch/recursive_r22 (two; the circuit the
    JAX package's two-proof recursive_vk.bin was made for) and of those two
    with a third (the reference's workload of three proofs)."""
    vk = VerificationKey.load(os.path.join(fixture, "vk.bin"))
    c, limbs = aggregation.build_aggregation_circuit(vk, _load_proofs(Proof, fixture, proofs))
    assert c.num_gates == gates
    assert len(c.values) == variables
    ref_c, ref_limbs = ref_aggregation.build_aggregation_circuit(
        ref_serialization.VerificationKey.load(os.path.join(fixture, "vk.bin")),
        _load_proofs(ref_serialization.Proof, fixture, proofs))
    assert limbs == ref_limbs
    assert c.public_inputs() == ref_c.public_inputs()
    assert _structure(c) == _structure(ref_c)
    assert _domain(c) == 1 << (21 if fixture == R5 else 22)
    if fixture == R5:
        agg = aggregation.AggregatedProof.load(os.path.join(R5, "recursive_proof.bin"))
        assert c.public_inputs() == agg.proof.input_values
        assert limbs == agg.aggr_limbs
    if len(proofs) == 3:
        _GATES[3] = _gate_digest(c)


def _recursive_vk_circuit(module, monkeypatch, vk, num_proofs):
    """The circuit module.make_recursive_vk synthesises for num_proofs
    (from its dummy proofs), caught before its setup and commitments."""
    built = []

    class Caught(Exception):
        pass

    def build(vk, proofs):
        built.append(real(vk, proofs)[0])
        raise Caught

    real = module.build_aggregation_circuit
    monkeypatch.setattr(module, "build_aggregation_circuit", build)
    with pytest.raises(Caught):
        module.make_recursive_vk(None, vk, num_proofs)
    monkeypatch.setattr(module, "build_aggregation_circuit", real)
    return built[0]


def test_recursive_vk_circuit_of_three_proofs(monkeypatch):
    """make_recursive_vk(num_proofs=3), which export-recursive-verification-key
    -c 3 runs, synthesises from dummy proofs the circuit of the JAX
    package's make_recursive_vk, witness included, and the gates of the
    circuit of the three real proofs."""
    c = _recursive_vk_circuit(aggregation, monkeypatch,
                              VerificationKey.load(os.path.join(R22, "vk.bin")), 3)
    assert c.num_gates == 3_003_875
    assert _domain(c) == 1 << 22
    digest = _gate_digest(c)
    ref_c = _recursive_vk_circuit(ref_aggregation, monkeypatch,
                                  ref_serialization.VerificationKey.load(
                                      os.path.join(R22, "vk.bin")), 3)
    assert _structure(c) == _structure(ref_c)
    del c, ref_c
    if 3 not in _GATES:
        real, _ = aggregation.build_aggregation_circuit(
            VerificationKey.load(os.path.join(R22, "vk.bin")),
            _load_proofs(Proof, R22, ["proof_0.bin", "proof_1.bin", THIRD]))
        _GATES[3] = _gate_digest(real)
    assert digest == _GATES[3]
