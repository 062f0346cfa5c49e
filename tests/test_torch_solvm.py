"""The port's contract interpreter (plonkit_tpu_torch/solvm.py) and contract
runner (plonkit_tpu_torch/contract.py) on the CPU, on in-repo data only:

- the verifier rendered from scratch/recursive_r22/vk.bin (domain 64) on
  the port's keccak proof of that directory's witness_0.json, made on the
  first 2^10 points of the in-repo tau = 42 key: accepted, and rejected
  when tampered; its transcript equals the port's host transcript;
- scratch/recursive_r5/recursive_verifier.sol on that directory's
  recursive_proof.json (the one-proof aggregate at 2^21): accepted, and
  rejected when tampered; its Rescue hash and limb codec equal the port's
  host ones;
- every call above gives the same result and the same struct fields
  through plonkit_tpu.solvm.Interpreter;
- the precompiles 0x05-0x07 equal the JAX package's, 0x08 equals
  plonkit_tpu.pairing.pairing_check_py;
- checked arithmetic: the port reverts where solc 0.8 does, the JAX
  package wraps (the documented divergence).

All values are exact integers: no tolerance.
"""

import json
import os
import random

import pytest
import torch

import plonkit_tpu.solvm as ref_solvm
from plonkit_tpu.pairing import pairing_check_py
from plonkit_tpu_torch import contract, native, solvm
from plonkit_tpu_torch.api import SetupForProver
from plonkit_tpu_torch.curve import G1_GEN, G2_GEN, g1_mul, g1_neg, g2_mul
from plonkit_tpu_torch.fields import FQ_MODULUS as Q, FR_MODULUS as R
from plonkit_tpu_torch.frontend import CircomCircuit, load_r1cs, load_witness
from plonkit_tpu_torch.recursive import rescue, rns
from plonkit_tpu_torch.serialization import CrsHandle, VerificationKey
from plonkit_tpu_torch.solidity import render_verification_key
from plonkit_tpu_torch.transcript import make_transcript

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R22 = os.path.join(REPO, "scratch", "recursive_r22")
R5 = os.path.join(REPO, "scratch", "recursive_r5")
KEY = os.path.join(R22, "srs_2pow22.key")
SEED = 20261017
WORD = (1 << 256) - 1


@pytest.fixture(autouse=True, scope="module")
def _env(tmp_path_factory):
    old_threads, old_build = torch.get_num_threads(), native.BUILD_DIR
    torch.set_num_threads(1)
    native.BUILD_DIR = str(tmp_path_factory.mktemp("native_build"))
    yield
    torch.set_num_threads(old_threads)
    native.BUILD_DIR = old_build


@pytest.fixture(scope="module")
def single():
    """(contract source, public inputs, proof words) of the domain-64
    circuit, its proof made by the port on the CPU."""
    vk = VerificationKey.load(os.path.join(R22, "vk.bin"))
    r1cs = load_r1cs(os.path.join(R22, "circuit.r1cs.json"))
    setup = SetupForProver(CircomCircuit(r1cs=r1cs), CrsHandle(KEY), device="cpu")
    assert setup.make_verification_key().to_bytes() == vk.to_bytes()
    proof = setup.prove(CircomCircuit(r1cs=r1cs,
                                      witness=load_witness(os.path.join(R22, "witness_0.json"))))
    inputs, words = proof.serialize_for_solidity()
    return render_verification_key(vk), inputs, words


@pytest.fixture(scope="module")
def recursive():
    """(contract source, verifyAggregatedProof arguments) of the 2^21
    one-proof aggregate."""
    with open(os.path.join(R5, "recursive_verifier.sol")) as f:
        source = f.read()
    with open(os.path.join(R5, "recursive_proof.json")) as f:
        return source, contract.recursive_arguments(json.load(f))


@pytest.fixture(scope="module")
def single_itp(single):
    return solvm.Interpreter(single[0])


@pytest.fixture(scope="module")
def recursive_itp(recursive):
    return solvm.Interpreter(recursive[0])


def _outcome(itp, module, fname, *args):
    """What a call gives: ("value", plain value) or ("revert", message)."""
    try:
        return "value", _plain(module, itp.call(fname, *args))
    except module.SolRevert as e:
        return "revert", str(e)


def _plain(module, v):
    if isinstance(v, module.StructVal):
        return (v.name, {k: _plain(module, x) for k, x in v.fields.items()})
    if isinstance(v, (list, tuple)):
        return [_plain(module, x) for x in v]
    return v


def _with(seq, i, v):
    out = list(seq)
    out[i] = v
    return out


# -- the domain-64 verifier -----------------------------------------------------

def test_contract_accepts_the_port_proof(single, single_itp):
    _, inputs, words = single
    assert single_itp.call("verify_serialized_proof", inputs, words) == 1


def test_contract_rejects_a_tampered_public_input(single, single_itp):
    _, inputs, words = single
    assert single_itp.call("verify_serialized_proof", [inputs[0] + 1] + inputs[1:], words) == 0


def test_contract_rejects_a_tampered_scalar_word(single, single_itp):
    _, inputs, words = single
    bad = _with(words, 18, (words[18] + 1) % (1 << 253))
    assert single_itp.call("verify_serialized_proof", inputs, bad) == 0


def test_contract_rejects_a_tampered_commitment(single, single_itp):
    _, inputs, words = single
    kind, value = _outcome(single_itp, solvm, "verify_serialized_proof", inputs,
                           _with(words, 0, words[0] + 1))
    assert (kind, value) == ("value", 0) or kind == "revert"


def test_contract_reverts_on_a_wrong_input_count(single, single_itp):
    _, _, words = single
    with pytest.raises(solvm.SolRevert):
        single_itp.call("verify_serialized_proof", [], words)


def test_contract_transcript_matches_host(single, single_itp):
    _, inputs, words = single
    t = make_transcript("keccak")
    for x in inputs:
        t.update_u256(x)
    for i in range(4):
        t.update_g1((words[2 * i], words[2 * i + 1]))
    parsed = single_itp.call("parse_proof", inputs, words)
    assert single_itp.call("derive_challenges", parsed).fields["beta"] == t.get_challenge()


# -- the recursive verifier -------------------------------------------------------

def test_recursive_contract_accepts_the_aggregate(recursive, recursive_itp):
    assert recursive_itp.call("verifyAggregatedProof", *recursive[1]) == 1


def test_recursive_contract_rejects_a_tampered_input(recursive, recursive_itp):
    limbs, root, inputs, words = recursive[1]
    assert recursive_itp.call("verifyAggregatedProof", limbs, root,
                              [inputs[0] + 1] + inputs[1:], words) == 0


@pytest.mark.parametrize("inputs", [[1, 2], [7], [3, 4, 5]])
def test_recursive_contract_rescue_matches_host(recursive_itp, inputs):
    assert recursive_itp.call("rescue_hash", inputs) == rescue.rescue_hash(inputs)


def test_recursive_contract_limbed_point_matches_rns(recursive_itp):
    p, q = g1_mul(G1_GEN, 12345), g1_mul(G1_GEN, 67890)
    limbs = rns.fq_to_limbs(p[0]) + rns.fq_to_limbs(p[1]) + rns.fq_to_limbs(q[0]) \
        + rns.fq_to_limbs(q[1])
    for off, want in ((0, p), (8, q)):
        got = recursive_itp.call("reconstruct_limbed_point", limbs, off)
        assert (got.fields["x"], got.fields["y"]) == want


def test_recursive_contract_rejects_a_wide_limb(recursive_itp):
    with pytest.raises(solvm.SolRevert):
        recursive_itp.call("reconstruct_limbed_point", [1 << 68] + [0] * 15, 0)


# -- parity with the JAX package's interpreter --------------------------------------

def _single_calls(single):
    _, inputs, words = single
    return {
        "valid": ("verify_serialized_proof", inputs, words),
        "public input": ("verify_serialized_proof", [inputs[0] + 1] + inputs[1:], words),
        "word 18": ("verify_serialized_proof", inputs,
                    _with(words, 18, (words[18] + 1) % (1 << 253))),
        "word 0": ("verify_serialized_proof", inputs, _with(words, 0, words[0] + 1)),
        "input count": ("verify_serialized_proof", [], words),
        "parse_proof": ("parse_proof", inputs, words),
    }


def _recursive_calls(recursive):
    limbs, root, inputs, words = recursive[1]
    return {
        "valid": ("verifyAggregatedProof", limbs, root, inputs, words),
        "individual input": ("verifyAggregatedProof", limbs, root,
                             [inputs[0] + 1] + inputs[1:], words),
        "limb": ("verifyAggregatedProof", [limbs[0] + 1] + limbs[1:], root, inputs, words),
        "vk_root": ("verifyAggregatedProof", limbs, root + 1, inputs, words),
        "rescue_hash": ("rescue_hash", [3, 4, 5]),
        "reconstruct_limbed_point": ("reconstruct_limbed_point", limbs, 8),
        "wide limb": ("reconstruct_limbed_point", [1 << 68] + [0] * 15, 0),
    }


@pytest.mark.parametrize("which", ["single", "recursive"])
def test_calls_match_the_jax_interpreter(request, which):
    data = request.getfixturevalue(which)
    calls = (_single_calls if which == "single" else _recursive_calls)(data)
    port, ref = solvm.Interpreter(data[0]), ref_solvm.Interpreter(data[0])
    for name, (fname, *args) in calls.items():
        got = _outcome(port, solvm, fname, *args)
        want = _outcome(ref, ref_solvm, fname, *args)
        assert got[0] == want[0], (name, got, want)
        if got[0] == "value":
            assert got == want, name
    # the structs the verifier derives from the proof, field by field
    if which == "single":
        parsed = [itp.call("parse_proof", *calls["valid"][1:]) for itp in (port, ref)]
        got, want = (itp.call("derive_challenges", p) for itp, p in zip((port, ref), parsed))
        assert _plain(solvm, got) == _plain(ref_solvm, want)


# -- the contract runner ---------------------------------------------------------------

def test_run_single_accepts_and_rejects(single, tmp_path):
    source, inputs, words = single
    sol, pj, ij = (str(tmp_path / n) for n in ("verifier.sol", "proof.json", "public.json"))
    with open(sol, "w") as f:
        f.write(source)
    with open(pj, "w") as f:
        json.dump([str(w) for w in words], f)
    with open(ij, "w") as f:
        json.dump([str(x) for x in inputs], f)
    found = contract.run_single(sol, pj, ij)
    assert found["accepted"]
    assert set(found["rejected"]) == {"public input 0 + 1", "word 18 + 1", "word 0 + 1"}
    # a valid proof the contract rejects: its public input does not match
    with open(ij, "w") as f:
        json.dump([str(inputs[0] + 1)] + [str(x) for x in inputs[1:]], f)
    with pytest.raises(contract.ContractCheckFailed, match="valid proof"):
        contract.run_single(sol, pj, ij)


def test_run_recursive_accepts_and_rejects(tmp_path):
    found = contract.run_recursive(os.path.join(R5, "recursive_verifier.sol"),
                                   os.path.join(R5, "recursive_proof.json"))
    assert found["accepted"]
    assert set(found["rejected"]) == {"individual input 0 + 1", "aggregate limb 0 + 1",
                                      "vk_root + 1"}


def test_run_recursive_raises_on_an_accepted_tampered_proof(monkeypatch):
    """A contract that accepts everything: the runner must raise."""
    monkeypatch.setattr(solvm.Interpreter, "call", lambda self, fname, *args: 1)
    with pytest.raises(contract.ContractCheckFailed, match="tampered"):
        contract.run_recursive(os.path.join(R5, "recursive_verifier.sol"),
                               os.path.join(R5, "recursive_proof.json"))


# -- precompiles -------------------------------------------------------------------------

def _g2_words(p):
    (x0, x1), (y0, y1) = p
    return [x1, x0, y1, y0]          # EVM order: (im, re)


def test_precompiles_0x05_to_0x07_match_jax():
    rng = random.Random(SEED)
    port, ref = solvm.default_precompiles(), ref_solvm.default_precompiles()
    for _ in range(4):
        a, b, k = (rng.randrange(1, R) for _ in range(3))
        p, q = g1_mul(G1_GEN, a), g1_mul(G1_GEN, b)
        cases = [
            (0x05, [32, 32, 32, rng.randrange(Q), rng.randrange(R), Q]),
            (0x05, [32, 32, 32, rng.randrange(Q), k, 0]),
            (0x06, [*p, *q]),
            (0x06, [*p, *g1_neg(p)]),
            (0x06, [0, 0, *q]),
            (0x07, [*p, k]),
            (0x07, [*p, 0]),
            (0x07, [0, 0, k]),
        ]
        for addr, words in cases:
            assert port(addr, words) == ref(addr, words), (hex(addr), words)


def test_precompile_0x08_matches_pairing_check_py():
    rng = random.Random(SEED + 1)
    a, b = rng.randrange(1, R), rng.randrange(1, R)
    p, q = g1_mul(G1_GEN, a), g2_mul(G2_GEN, b)
    ab = g1_mul(G1_GEN, a * b % R)
    cases = [
        [],
        [(p, q), (g1_neg(p), q)],
        [(p, q)],
        [(None, q), (p, q), (g1_neg(p), q)],
        [(p, None), (ab, G2_GEN), (g1_neg(p), q)],
        [(ab, G2_GEN), (g1_neg(p), q), (p, q), (g1_neg(ab), G2_GEN)],
        [(ab, G2_GEN), (g1_neg(p), q), (p, q), (ab, G2_GEN)],
    ]
    run = solvm.default_precompiles()
    for pairs in cases:
        words = []
        for g1, g2 in pairs:
            words += [0, 0] if g1 is None else [*g1]
            words += [0, 0, 0, 0] if g2 is None else _g2_words(g2)
        want = pairing_check_py([pr for pr in pairs if None not in pr])
        assert run(0x08, words) == (True, [int(want)]), pairs


@pytest.mark.parametrize("addr", [0x06, 0x07, 0x08])
def test_precompile_reverts_on_an_off_curve_point(addr):
    x, y = 1, 3                                          # y^2 != x^3 + 3
    words = {0x06: [x, y, *G1_GEN], 0x07: [x, y, 5],
             0x08: [x, y, *_g2_words(G2_GEN)]}[addr]
    with pytest.raises(solvm.SolRevert, match="not on curve"):
        solvm.default_precompiles()(addr, words)


# -- checked arithmetic ------------------------------------------------------------------

ARITH = """
pragma solidity >=0.6.0 <0.9.0;
contract Arith {
    function add(uint256 a, uint256 b) public pure returns (uint256) { return a + b; }
    function sub(uint256 a, uint256 b) public pure returns (uint256) { return a - b; }
    function mul(uint256 a, uint256 b) public pure returns (uint256) { return a * b; }
    function add_assign(uint256 a, uint256 b) public pure returns (uint256) {
        a += b;
        return a;
    }
    function dec(uint256 a) public pure returns (uint256) {
        a--;
        return a;
    }
    function div(uint256 a, uint256 b) public pure returns (uint256) { return a / b; }
    function cast(uint256 a) public pure returns (uint256) { return uint256(uint32(a)); }
}
"""


@pytest.mark.parametrize("fname,args,wrapped", [
    ("add", (WORD, 1), 0),
    ("sub", (0, 1), WORD),
    ("mul", (1 << 128, 1 << 128), 0),
    ("add_assign", (WORD, 2), 1),
    ("dec", (0,), WORD),
])
def test_overflow_reverts_in_the_port_and_wraps_in_jax(fname, args, wrapped):
    with pytest.raises(solvm.SolRevert, match="overflow"):
        solvm.Interpreter(ARITH).call(fname, *args)
    assert ref_solvm.Interpreter(ARITH).call(fname, *args) == wrapped


@pytest.mark.parametrize("fname,args,want", [
    ("add", (WORD - 1, 1), WORD),
    ("sub", (5, 5), 0),
    ("mul", ((1 << 128) - 1, (1 << 128) + 1), WORD),
    ("dec", (1,), 0),
    ("div", (7, 2), 3),
    ("cast", ((1 << 40) + 9, ), 9),
])
def test_in_range_arithmetic_and_casts_match_jax(fname, args, want):
    assert solvm.Interpreter(ARITH).call(fname, *args) == want
    assert ref_solvm.Interpreter(ARITH).call(fname, *args) == want


def test_division_by_zero_reverts():
    for module in (solvm, ref_solvm):
        with pytest.raises(module.SolRevert, match="division by zero"):
            module.Interpreter(ARITH).call("div", 1, 0)
