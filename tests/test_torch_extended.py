"""The port's extended gate system (plonkit_tpu_torch/plonk/extended.py) on
the CPU against the JAX package's (plonkit_tpu/plonk/extended.py on its
HostBackend): the demo circuit of tests/test_extended.py, built through
each package's own CsBuilder, gives the same setup polynomials, the same
VerificationKey2 bytes and the same prove2 bytes under both transcripts;
verify2 accepts and rejects what the JAX package's tests do; and each
TorchBackend method the extended prover needs equals HostBackend's on
seeded vectors.  SRS: the first 2^10 points of the in-repo tau = 42 key,
each package reading it with its own loader."""

import io

import numpy as np
import pytest
import torch

from plonkit_tpu.backend import HostBackend
from plonkit_tpu.plonk import extended as ref_ext
from plonkit_tpu.recursive.cs import CsBuilder as RefCsBuilder
from plonkit_tpu_torch import native
from plonkit_tpu_torch.backend_torch import TorchBackend
from plonkit_tpu_torch.fields import FR_MODULUS as R
from plonkit_tpu_torch.plonk import extended as ext
from plonkit_tpu_torch.recursive.cs import CsBuilder
from plonkit_tpu_torch.serialization import CrsHandle, Proof

from test_torch_prove import KEY, ref_crs

SEED = 20241017


@pytest.fixture(autouse=True, scope="module")
def _env(tmp_path_factory):
    old_threads, old_build = torch.get_num_threads(), native.BUILD_DIR
    torch.set_num_threads(1)
    native.BUILD_DIR = str(tmp_path_factory.mktemp("native_build"))
    yield
    torch.set_num_threads(old_threads)
    native.BUILD_DIR = old_build


def build_demo_circuit(cs_class, x_val=3):
    """tests/test_extended.py:build_demo_circuit over either package's
    CsBuilder: public x, y = x^3 + x + 5, range chains (the custom gate),
    booleans, select, inverse and division."""
    cs = cs_class()
    x = cs.alloc_input(x_val)
    x2 = cs.mul(x, x)
    x3 = cs.mul(x2, x)
    y = cs.lc([(x3, 1), (x, 1)], constant=5)
    cs.enforce_constant(y, (x_val ** 3 + x_val + 5) % R)
    v = cs.alloc(0xAB)
    cs.enforce_range(v, 8)
    w = cs.alloc(0xBEEF)
    chunks = cs.decompose_chunks(w, 16)
    assert len(chunks) == 8
    b = cs.boolean(1)
    sel = cs.select(b, x2, x3)
    cs.enforce_equal(sel, x2)
    inv = cs.inverse(x3)
    one = cs.mul(inv, x3)
    cs.enforce_constant(one, 1)
    q = cs.div(x3, x)
    cs.enforce_equal(q, x2)
    return cs


@pytest.fixture(scope="module")
def demo():
    """Both packages' circuits, setups, vks and keccak proofs."""
    cs, ref_cs = build_demo_circuit(CsBuilder), build_demo_circuit(RefCsBuilder)
    setup, ref_setup = cs.setup(), ref_cs.setup()
    crs, ref_srs = CrsHandle(KEY), ref_crs(KEY, setup.domain_size)
    be, ref_be = TorchBackend("cpu"), HostBackend()
    vk = ext.make_verification_key2(setup, crs, backend=be)
    ref_vk = ref_ext.make_verification_key2(ref_setup, ref_srs, backend=ref_be)
    cols, pub = cs.wire_columns(), cs.public_inputs()
    proof = ext.prove2(setup, cols, pub, crs=crs, backend=be)
    ref_proof = ref_ext.prove2(ref_setup, ref_cs.wire_columns(), ref_cs.public_inputs(),
                               crs=ref_srs, backend=ref_be)
    return dict(cs=cs, ref_cs=ref_cs, setup=setup, ref_setup=ref_setup, crs=crs,
                ref_srs=ref_srs, be=be, ref_be=ref_be, vk=vk, ref_vk=ref_vk,
                proof=proof, ref_proof=ref_proof)


def vk_bytes(vk):
    buf = io.BytesIO()
    vk.write(buf)
    return buf.getvalue()


def test_demo_circuit_structure_matches(demo):
    cs, ref_cs = demo["cs"], demo["ref_cs"]
    assert cs.num_gates == ref_cs.num_gates
    assert cs.wire_columns() == ref_cs.wire_columns()
    assert cs.public_inputs() == ref_cs.public_inputs()
    setup, ref_setup = demo["setup"], demo["ref_setup"]
    assert setup.domain_size == ref_setup.domain_size <= 1024
    assert setup.selectors == ref_setup.selectors
    assert np.array_equal(setup.perm_label_idx, ref_setup.perm_label_idx)
    assert setup.permutations == ref_setup.permutations


def test_vk2_bytes_match(demo):
    assert vk_bytes(demo["vk"]) == vk_bytes(demo["ref_vk"])


@pytest.mark.parametrize("transcript", ["keccak", "rescue"])
def test_prove2_bytes_match(demo, transcript):
    if transcript == "keccak":
        proof, ref_proof = demo["proof"], demo["ref_proof"]
    else:
        cs, ref_cs = demo["cs"], demo["ref_cs"]
        proof = ext.prove2(demo["setup"], cs.wire_columns(), cs.public_inputs(),
                           crs=demo["crs"], backend=demo["be"], transcript=transcript)
        ref_proof = ref_ext.prove2(demo["ref_setup"], ref_cs.wire_columns(),
                                   ref_cs.public_inputs(), crs=demo["ref_srs"],
                                   backend=demo["ref_be"], transcript=transcript)
    assert proof.to_bytes() == ref_proof.to_bytes()
    assert ext.verify2(demo["vk"], proof, transcript=transcript)
    other = "keccak" if transcript == "rescue" else "rescue"
    assert not ext.verify2(demo["vk"], proof, transcript=other)


def test_verify2_rejects_wrong_public_input(demo):
    proof = Proof.read(io.BytesIO(demo["proof"].to_bytes()))
    proof.input_values[0] = (proof.input_values[0] + 1) % R
    assert not ext.verify2(demo["vk"], proof)
    assert not ref_ext.verify2(demo["ref_vk"], proof)


def test_vk2_roundtrip(demo):
    vk = ext.VerificationKey2.read(io.BytesIO(vk_bytes(demo["vk"])))
    assert vk == demo["vk"]
    assert vk_bytes(vk) == vk_bytes(demo["vk"])


def test_tampered_witness_rejected_by_both_validators_and_prove2(demo):
    cs, setup, be = demo["cs"], demo["setup"], demo["be"]
    cols, pub = cs.wire_columns(), cs.public_inputs()
    ext.validate_witness2(setup, cols, pub)
    ext.validate_witness2_fast(setup, cols, pub, backend=be)
    row = next(i for i, s in enumerate(setup.selectors[ext.Q_RANGE]) if s)
    cols[2][row] = (cols[2][row] + 7) % R
    with pytest.raises(ext.ProverError):
        ext.validate_witness2(setup, cols, pub)
    with pytest.raises(ext.ProverError):
        ext.validate_witness2_fast(setup, cols, pub, backend=be)
    with pytest.raises(ext.ProverError):
        ext.prove2(setup, cols, pub, crs=demo["crs"], backend=be)


def test_fast_validator_agrees_on_main_gate_fault(demo):
    cs, setup, be = demo["cs"], demo["setup"], demo["be"]
    cols, pub = cs.wire_columns(), cs.public_inputs()
    bad_pub = [(pub[0] + 1) % R] + pub[1:]
    with pytest.raises(ext.ProverError, match="main gate"):
        ext.validate_witness2(setup, cols, bad_pub)
    with pytest.raises(ext.ProverError, match="main gate"):
        ext.validate_witness2_fast(setup, cols, bad_pub, backend=be)


def test_range_chain_soundness():
    """A chain cell holding a too-wide value fails both validators."""
    cs = CsBuilder()
    cs.alloc_input(1)
    v = cs.alloc(0x3FF)
    cs.enforce_range(v, 16)
    setup = cs.setup()
    cols = cs.wire_columns()
    ext.validate_witness2(setup, cols, cs.public_inputs())
    for col in cols:
        for i, val in enumerate(col):
            if val == 0x3FF:
                col[i] = 1 << 16
    with pytest.raises(ext.ProverError):
        ext.validate_witness2(setup, cols, cs.public_inputs())
    with pytest.raises(ext.ProverError):
        ext.validate_witness2_fast(setup, cols, cs.public_inputs(), backend=TorchBackend("cpu"))


# -- the TorchBackend methods of the extended prover -------------------------

def _vectors(n=257, count=3):
    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(count):
        vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
        vals[:4] = [0, 1, R - 1, R - 2]
        out.append(vals)
    return out


@pytest.mark.parametrize("method", ["mul", "add", "add_scalar", "fma_acc", "add_into",
                                    "mul_into", "grand_product", "batch_inverse",
                                    "offload_onload"])
def test_backend_method_matches_host_backend(method):
    be, host = TorchBackend("cpu"), HostBackend()
    a, b, c = _vectors()
    A, B, C = (be.from_ints(v) for v in (a, b, c))
    k = 0xC0FFEE ** 9 % R
    if method == "mul":
        got, want = be.mul(A, B), host.mul(a, b)
    elif method == "add":
        got, want = be.add(A, B), host.add(a, b)
    elif method == "add_scalar":
        got, want = be.add_scalar(A, k), host.add_scalar(a, k)
    elif method == "fma_acc":
        got, want = be.fma_acc(C, A, B), host.add(c, host.mul(a, b))
    elif method == "add_into":
        got, want = be.add_into(C, A), host.add(c, a)
    elif method == "mul_into":
        got, want = be.mul_into(C, A), host.mul(c, a)
    elif method == "grand_product":
        got, want = be.grand_product(A), host.grand_product(a)
    elif method == "batch_inverse":
        got, want = be.batch_inverse(A), host.batch_inverse(a)
    else:
        got, want = be.onload(be.offload(A)), a
    assert be.to_ints(got) == list(want)
