"""The port's tensor-core NTT engine (plonkit_tpu_torch/gpu/ntt_mxu.py, the
plain versions of K9-K11 on the CPU) against the JAX package's
plonkit_tpu/tpu/ntt_mxu.py: the radix plan, the int8 DFT tables and the
twiddles byte for byte, the digits and the fold on seeded and edge inputs,
and the five transforms limb for limb; against the port's butterfly
engine (gpu/ntt.py); and TorchBackend's engine selection by
PLONKIT_TPU_NTT (backend_torch._NTT_ENGINE), whose two engines give the
JAX package's proof.bin at 2^10.  Every comparison is exact.  The JAX
module's table cache is pointed at a temporary directory."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonkit_tpu.api import SetupForProver as RefSetupForProver
from plonkit_tpu.backend import HostBackend
from plonkit_tpu.frontend.circuit import CircomCircuit as RefCircuit
from plonkit_tpu.frontend.r1cs import R1CS as RefR1CS
from plonkit_tpu.serialization import Crs as RefCrs
from plonkit_tpu.serialization import CrsHandle as RefCrsHandle
from plonkit_tpu.serialization import load_crs_g1_limbs as ref_load_crs_g1_limbs
from plonkit_tpu.tpu import ntt_mxu as ref_mxu
from plonkit_tpu.tpu.mont import FR as REF_FR
from plonkit_tpu_torch import backend_torch, convert, native
from plonkit_tpu_torch.api import SetupForProver
from plonkit_tpu_torch.backend_torch import FrVec, TorchBackend
from plonkit_tpu_torch.fields import FR_MODULUS as R
from plonkit_tpu_torch.frontend.synthetic import synth_circuit
from plonkit_tpu_torch.gpu import mont, ntt as gntt, ntt_mxu as mxu
from plonkit_tpu_torch.serialization import CrsHandle

KEY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "scratch", "recursive_r22", "srs_2pow22.key")


@pytest.fixture(autouse=True, scope="module")
def _env(tmp_path_factory):
    old = (torch.get_num_threads(), native.BUILD_DIR, ref_mxu._TABLE_DIR)
    torch.set_num_threads(1)
    native.BUILD_DIR = str(tmp_path_factory.mktemp("native_build"))
    ref_mxu._TABLE_DIR = str(tmp_path_factory.mktemp("ntt_tables"))
    yield
    torch.set_num_threads(old[0])
    native.BUILD_DIR, ref_mxu._TABLE_DIR = old[1], old[2]


def rand_elems(n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(max(n - 4, 0))]
    return (vals + [0, 1, R - 1, R - 2])[:n]


def edge_elems():
    """0, 1, p - 1, p - 2, and values whose bytes are all 0x7F, 0x80 or
    0xFF (top byte 0x20, below p's) or alternate 0x7F / 0x80: each digit
    boundary carries, or just does not."""
    out = [0, 1, R - 1, R - 2, (1 << 248) - 1, 1 << 247]
    for pattern in ([0x7F], [0x80], [0xFF], [0x7F, 0x80], [0x80, 0x7F]):
        body = (pattern * 31)[:31]
        out.append(int.from_bytes(bytes(body + [0x20]), "little"))
    return out


def port_rows(xs):
    """Canonical ints -> [N, 8] int32 Montgomery rows on the CPU."""
    return mont.to_tensor(mont.FR.to_mont_np(xs), "cpu")


def planar(rows):
    """[N, 8] rows -> the JAX package's [16, N] limbs."""
    return convert.rows_to_limbs16(mont.to_numpy(rows))


def same(port_t, ref_arr):
    return np.array_equal(planar(port_t.reshape(-1, 8)), np.asarray(ref_arr))


def test_plan_radices_match_reference():
    for k in range(1, 25):
        assert mxu.plan_radices(1 << k) == ref_mxu.plan_radices(1 << k), k
    assert mxu.plan_radices(1 << 20) == (128, 128, 64)
    assert mxu.plan_radices(512) == (32, 16)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("r", [16, 32, 64])
def test_dft_table_matches_reference(r, inverse):
    got = mxu._dft_table(r, inverse, "cpu")
    assert got.shape == (r * 33, mxu.padded_depth(r)) and got.dtype == torch.int8
    assert np.array_equal(got[:, :r * 33].numpy(), ref_mxu._dft_table_np(r, inverse))
    assert not got[:, r * 33:].any()
    assert mxu.padded_depth(r) == (544 if r == 16 else r * 33)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m,n1", [(512, 32), (4096, 64), (1 << 14, 128)])
def test_twiddle_table_matches_reference(m, n1, inverse):
    got = mxu._twiddles(m, n1, inverse, "cpu")
    want = ref_mxu._twiddle_table_np(m, n1, inverse)           # [16, N2, N1]
    assert got.shape == (m // n1, n1, 8)
    assert same(got, want.reshape(16, -1))


def test_digits_match_reference():
    """K9's plain version against _to_balanced: r = 16 (the padded depth),
    B = 3, seeded values and the edge values; every row's padding zero."""
    r, batch = 16, 3
    xs = (edge_elems() + rand_elems(r * batch, 40))[:r * batch]
    rows = port_rows(xs).view(r, batch, 8)
    got = mxu.balanced_digits(rows)
    assert got.shape == (batch, mxu.padded_depth(r))
    want = np.asarray(ref_mxu._to_balanced(jnp.asarray(planar(rows.view(-1, 8)))))  # [33, r*B]
    want = want.reshape(33, r, batch).transpose(2, 1, 0).reshape(batch, r * 33)
    assert np.array_equal(got[:, :r * 33].numpy(), want)
    assert not got[:, r * 33:].any()
    # the digits give the value back
    d = got[:, :r * 33].to(torch.int64).view(batch, r, 33)
    for b in range(batch):
        for k in range(r):
            v = sum(int(d[b, k, t]) << (8 * t) for t in range(33))
            assert v == mont.FR.from_limbs_np(mont.to_numpy(rows[k, b:b + 1]))[0]


def test_fold_matches_reference():
    """K11's plain version against _fold_redc on seeded digits and at the
    extremes +-256 * 33 * 128^2 (the largest radix's bound)."""
    r, batch = 4, 8
    bound = 256 * 33 * 128 * 128
    rng = np.random.default_rng(41)
    g = rng.integers(-bound, bound + 1, size=(r, 33, batch), dtype=np.int64)
    g[0, :, 0], g[0, :, 1], g[0, :, 2] = bound, -bound, 0
    g[1, :, 0] = np.where(np.arange(33) % 2, bound, -bound)
    g[1, :, 1] = np.where(np.arange(33) % 2, -bound, bound)
    g[1, 32, 2], g[1, 0, 3] = bound, -bound
    g = g.astype(np.int32)
    got = mxu.fold_redc(torch.from_numpy(g.reshape(r * 33, batch)))
    want = np.asarray(ref_mxu._fold_redc(jnp.asarray(g)))          # [16, r, B]
    assert got.shape == (r, batch, 8)
    assert same(got, want.reshape(16, -1))
    # the value: (sum_t G_t 2^(8t)) * 2^-48, in Montgomery form
    inv48 = pow(1 << 48, -1, R)
    vals = mont.FR.from_limbs_np(mont.to_numpy(got.view(-1, 8)))
    for i, (m, b) in enumerate((m, b) for m in range(r) for b in range(batch)):
        v = sum(int(g[m, t, b]) << (8 * t) for t in range(33))
        assert vals[i] == v * inv48 % R


def test_product_plain_is_exact():
    """K10's plain version at the largest |G_t| a table and digits give."""
    k = mxu.padded_depth(64)
    a = torch.full((64 * 33, k), -128, dtype=torch.int8)
    x = torch.full((5, k), -128, dtype=torch.int8)
    x[1] = 127
    g = mxu.dft_product(a, x)
    assert g.dtype == torch.int32 and g.shape == (64 * 33, 5)
    assert int(g[0, 0]) == k * 128 * 128 and int(g[0, 1]) == -k * 128 * 127


def _ref_transforms(xs, coeffs):
    x = jnp.asarray(REF_FR.to_mont_np(xs))
    c = jnp.asarray(REF_FR.to_mont_np(coeffs))
    return {"ntt": ref_mxu.ntt_mxu(x), "intt": ref_mxu.intt_mxu(x),
            "coset_ntt": ref_mxu.coset_ntt_mxu(x), "coset_intt": ref_mxu.coset_intt_mxu(x),
            "coset_lde": ref_mxu.coset_lde_mxu(c, 4)}


def _port_transforms(module, suffix, xs, coeffs):
    x, c = port_rows(xs), port_rows(coeffs)
    f = {op: getattr(module, op + suffix) for op in
         ("ntt", "intt", "coset_ntt", "coset_intt", "coset_lde")}
    return {"ntt": f["ntt"](x), "intt": f["intt"](x), "coset_ntt": f["coset_ntt"](x),
            "coset_intt": f["coset_intt"](x), "coset_lde": f["coset_lde"](c, 4)}


@pytest.mark.parametrize("n", [512, 4096])
def test_transforms_match_reference(n):
    """The five transforms of n points (the LDE of n/4 coefficients)
    against the JAX package's ntt_mxu, run on the CPU as
    tests/test_ntt_mxu.py runs it."""
    xs, coeffs = rand_elems(n, 50 + n), rand_elems(n // 4, 51 + n)
    got = _port_transforms(mxu, "_mxu", xs, coeffs)
    want = _ref_transforms(xs, coeffs)
    for op in got:
        assert same(got[op], want[op]), op
    assert torch.equal(mxu.intt_mxu(got["ntt"]), port_rows(xs))


@pytest.mark.parametrize("n", [2, 8, 32, 512, 1024, 4096])
def test_transforms_match_butterflies(n):
    xs, coeffs = rand_elems(n, 60 + n), rand_elems(max(n // 4, 1), 61 + n)
    got = _port_transforms(mxu, "_mxu", xs, coeffs)
    want = _port_transforms(gntt, "", xs, coeffs)
    for op in got:
        assert torch.equal(got[op], want[op]), op


def test_engine_selection(monkeypatch):
    cpu, card = torch.device("cpu"), torch.device("cuda")
    monkeypatch.setattr(backend_torch, "_NTT_ENGINE", "auto")
    assert backend_torch._use_mxu_ntt(512, card) and not backend_torch._use_mxu_ntt(256, card)
    assert not backend_torch._use_mxu_ntt(1 << 20, cpu)
    monkeypatch.setattr(backend_torch, "_NTT_ENGINE", "mxu")
    assert backend_torch._use_mxu_ntt(2, cpu) and backend_torch._use_mxu_ntt(1 << 20, card)
    monkeypatch.setattr(backend_torch, "_NTT_ENGINE", "pease")
    assert not backend_torch._use_mxu_ntt(1 << 20, card)
    monkeypatch.setattr(backend_torch, "_NTT_ENGINE", "fast")
    with pytest.raises(ValueError):
        backend_torch._use_mxu_ntt(512, card)


def _spy(monkeypatch):
    """Count the calls of K9 (the tensor-core engine) and K3/K5 (the
    butterflies): on the CPU each runs its plain version, uncounted."""
    calls = {"mxu": 0, "pease": 0}
    for module, name, engine in ((mxu, "balanced_digits", "mxu"),
                                 (gntt, "butterfly_dif", "pease"), (gntt, "butterfly", "pease")):
        fn = getattr(module, name)

        def wrapped(*args, _fn=fn, _engine=engine, **kwargs):
            calls[_engine] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("engine", ["mxu", "pease"])
def test_backend_transforms_take_the_selected_engine(monkeypatch, engine):
    """Every TorchBackend transform, and the split coset paths at a
    threshold lowered from 2^24 to 4 * 512 elements, through the engine
    that PLONKIT_TPU_NTT names; the same rows as the other engine."""
    n = 512
    b = TorchBackend(device="cpu")
    v = FrVec(port_rows(rand_elems(n, 70)))
    wide = FrVec(port_rows(rand_elems(4 * n, 71)))
    monkeypatch.setattr(backend_torch, "_NTT_ENGINE", "pease" if engine == "mxu" else "mxu")
    want = [b.ntt(v), b.intt(v), b.coset_ntt(wide), b.coset_intt(wide), b.coset_lde(v, 4)]
    monkeypatch.setattr(backend_torch, "_NTT_ENGINE", engine)
    calls = _spy(monkeypatch)
    got = [b.ntt(v), b.intt(v), b.coset_ntt(wide), b.coset_intt(wide), b.coset_lde(v, 4)]
    other = "pease" if engine == "mxu" else "mxu"
    assert calls[engine] > 0 and calls[other] == 0
    monkeypatch.setattr(backend_torch, "SPLIT_NTT_MIN", 4 * n)
    calls[engine] = 0
    split = [b.coset_ntt(wide), b.coset_intt(wide), b.coset_lde(v, 4)]
    assert calls[engine] > 0 and calls[other] == 0
    for g, w in zip(got + split, want + want[2:]):
        assert torch.equal(g.data, w.data)


def _ref_crs(path, count):
    x, y, inf = ref_load_crs_g1_limbs(path, count)
    weights = [1 << (16 * k) for k in range(16)]

    def ints(limbs):
        return [sum(int(v) * w for v, w in zip(col, weights)) for col in limbs.T]
    points = [None if i else p for p, i in zip(zip(ints(x), ints(y)), inf)]
    return RefCrs(points, RefCrsHandle(path).g2_monomial_bases)


def test_engines_prove_the_reference_bytes(monkeypatch):
    """The synthetic chain at 2^10 proved by TorchBackend on the CPU under
    each engine: vk.bin and proof.bin equal the JAX package's HostBackend
    bytes, and the engine's kernels (plain versions) did the transforms."""
    log2 = 10
    circuit = synth_circuit(log2 - 1)
    r = circuit.r1cs
    ref_circuit = RefCircuit(r1cs=RefR1CS(num_inputs=r.num_inputs, num_aux=r.num_aux,
                                          num_variables=r.num_variables,
                                          constraints=r.constraints),
                             witness=list(circuit.witness))
    ref = RefSetupForProver(ref_circuit, _ref_crs(KEY, 1 << log2), backend=HostBackend())
    want = ref.make_verification_key().to_bytes(), ref.prove(ref_circuit).to_bytes()
    for engine in ("mxu", "pease"):
        monkeypatch.setattr(backend_torch, "_NTT_ENGINE", engine)
        with monkeypatch.context() as m:
            calls = _spy(m)
            setup = SetupForProver(circuit, CrsHandle(KEY), device="cpu")
            assert setup.setup_polynomials.domain_size == 1 << log2
            got = setup.make_verification_key().to_bytes(), setup.prove(circuit).to_bytes()
        assert got == want, engine
        assert calls[engine] > 0 and calls["pease" if engine == "mxu" else "mxu"] == 0


def test_wrappers_reject_bad_operands():
    rows = torch.zeros((16, 2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        mxu.balanced_digits(rows.view(32, 8))
    with pytest.raises(ValueError):
        mxu.balanced_digits(rows.to(torch.int64))
    with pytest.raises(ValueError):
        mxu.dft_product(torch.zeros((33, 40), dtype=torch.int8),
                        torch.zeros((2, 40), dtype=torch.int8))
    with pytest.raises(ValueError):
        mxu.dft_product(torch.zeros((33, 64), dtype=torch.int8),
                        torch.zeros((2, 32), dtype=torch.int8))
    with pytest.raises(ValueError):
        mxu.fold_redc(torch.zeros((34, 2), dtype=torch.int32))
