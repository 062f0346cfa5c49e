"""K4 mul_add and K5 DIT butterfly of the port, and the inverse transforms
that K5 carries: the wrappers on CPU tensors (their plain versions in
gpu/mont.py) against the Pallas kernels they replace, run in interpret
mode, for Fr and Fq on the edge values 0, 1, p-1, p-2 and seeded random
values; the DIT `intt` / `coset_intt` against plonkit_tpu/tpu/ntt.py and
against the DIF form of the same inverse.  Integer arithmetic: every
comparison is exact.  The CUDA kernels run on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonkit_tpu.fields import FQ_MODULUS, FR_GENERATOR, FR_MODULUS as R
from plonkit_tpu.plonk import poly_host
from plonkit_tpu.tpu import mont as ref_mont
from plonkit_tpu.tpu import ntt as ref_ntt
from plonkit_tpu.tpu import pallas_kernels as pk
from plonkit_tpu_torch import convert
from plonkit_tpu_torch.fields import fr_inv
from plonkit_tpu_torch.gpu import field_kernels as fk
from plonkit_tpu_torch.gpu import mont, ntt

FIELDS = [(mont.FR, ref_mont.FR, R), (mont.FQ, ref_mont.FQ, FQ_MODULUS)]
IDS = ["fr", "fq"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def rand_elems(n, p, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(max(n - 4, 0))]
    return (vals + [0, 1, p - 1, p - 2])[:n]


def both(ref_spec, xs):
    """The same Montgomery values in both layouts: (jax [16, N], torch [N, 8])."""
    planar = ref_spec.to_mont_np(xs)
    return jnp.asarray(planar), torch.from_numpy(convert.limbs16_to_rows(planar).view(np.int32))


def same(port_t, ref_arr):
    return np.array_equal(convert.rows_to_limbs16(mont.to_numpy(port_t)), np.asarray(ref_arr))


def ints(spec, t):
    return spec.from_mont_np(mont.to_numpy(t))


@pytest.mark.parametrize("spec,ref_spec,p", FIELDS, ids=IDS)
def test_mul_add_matches_pallas_interpret(spec, ref_spec, p):
    xs, ys, zs = rand_elems(64, p, 1), rand_elems(64, p, 2)[::-1], rand_elems(64, p, 3)
    (ja, ta), (jb, tb), (jc, tc) = (both(ref_spec, v) for v in (xs, ys, zs))
    before = dict(fk.launches)
    got = fk.mul_add(spec, ta, tb, tc)
    assert same(got, pk.mul_add(ref_spec, ja, jb, jc, interpret=True))
    assert torch.equal(got, fk.add(spec, fk.mul(spec, ta, tb), tc))
    assert ints(spec, got) == [(x * y + z) % p for x, y, z in zip(xs, ys, zs)]
    assert fk.launches == before


@pytest.mark.parametrize("spec,ref_spec,p", FIELDS, ids=IDS)
@pytest.mark.parametrize("strided", [False, True], ids=["rows", "interleaved"])
def test_butterfly_matches_pallas_interpret(spec, ref_spec, p, strided):
    """K5 on separate row blocks, and on the even / odd rows of one buffer
    as the inverse transform hands them over."""
    n = 64
    xs, ys, ws = rand_elems(n, p, 4), rand_elems(n, p, 5)[::-1], rand_elems(n, p, 6)
    (jlo, tlo), (jhi, thi), (jw, tw) = (both(ref_spec, v) for v in (xs, ys, ws))
    if strided:
        buf = torch.stack([tlo, thi], dim=1).reshape(2 * n, 8)
        tlo, thi = buf[0::2], buf[1::2]
        assert not tlo.is_contiguous()
    before = dict(ntt.launches)
    lo, hi = ntt.butterfly(spec, tlo, thi, tw)
    want_lo, want_hi = pk.butterfly(ref_spec, jlo, jhi, jw, interpret=True)
    assert same(lo, want_lo) and same(hi, want_hi)
    assert ints(spec, lo) == [(x + w * y) % p for x, y, w in zip(xs, ys, ws)]
    assert ints(spec, hi) == [(x - w * y) % p for x, y, w in zip(xs, ys, ws)]
    assert ntt.launches == before


def test_butterfly_writes_the_halves_of_out():
    _, lo = both(ref_mont.FR, rand_elems(16, R, 7))
    _, hi = both(ref_mont.FR, rand_elems(16, R, 8))
    _, w = both(ref_mont.FR, rand_elems(16, R, 9))
    out = torch.empty((32, 8), dtype=torch.int32)
    a, b = ntt.butterfly(mont.FR, lo, hi, w, out)
    assert a.data_ptr() == out.data_ptr() and b.data_ptr() == out[16:].data_ptr()
    assert torch.equal(torch.cat([a, b]), torch.cat(mont.butterfly(mont.FR, lo, hi, w)))


@pytest.mark.parametrize("bad", ["lo_shape", "stride_mismatch", "half_row", "w_strided",
                                 "out_shape"])
def test_butterfly_rejects_bad_operands(bad):
    buf = torch.zeros((16, 8), dtype=torch.int32)
    lo, hi, w, out = buf[0::2], buf[1::2], torch.zeros((8, 8), dtype=torch.int32), None
    if bad == "lo_shape":
        lo = buf[:4]
    elif bad == "stride_mismatch":
        hi = buf[8:]
    elif bad == "half_row":
        flat = torch.zeros((12 * 8,), dtype=torch.int32)
        lo = torch.as_strided(flat, (8, 8), (12, 1))
        hi = torch.as_strided(flat, (8, 8), (12, 1), 4)
    elif bad == "w_strided":
        w = buf[0::2]
    elif bad == "out_shape":
        out = torch.zeros((8, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        ntt.butterfly(mont.FR, lo, hi, w, out)


def dif_intt(t):
    """The inverse on the forward DIF transform (K3): intt(x)[k] =
    n^-1 * ntt(x')[k] with x'[j] = x[-j mod n]."""
    n = t.shape[0]
    neg = torch.tensor([(-j) % n for j in range(n)])
    return fk.mul(mont.FR, ntt.ntt(t.index_select(0, neg)), mont.FR.const(fr_inv(n), n, "cpu"))


@pytest.mark.parametrize("log_n", range(1, 11))
def test_dit_intt_matches_host_reference_and_dif_form(log_n):
    """intt and coset_intt at every size from 2 to 1024 points against the
    JAX package's host transforms (plonk/poly_host.py) and the DIF form."""
    n = 1 << log_n
    xs = rand_elems(n, R, 40 + log_n)
    _, t = both(ref_mont.FR, xs)
    before = ntt.launches["butterfly"]
    inv = ntt.intt(t)
    assert ints(mont.FR, inv) == poly_host.intt(list(xs))
    assert torch.equal(inv, dif_intt(t))
    assert torch.equal(ntt.ntt(inv), t)
    co = ntt.coset_intt(t)
    assert ints(mont.FR, co) == poly_host.coset_intt(list(xs))
    assert torch.equal(co, ntt.coset_scale(dif_intt(t), fr_inv(FR_GENERATOR)))
    assert ntt.launches["butterfly"] == before


@pytest.mark.parametrize("log_n", [1, 4])
def test_dit_intt_matches_tpu_ntt(log_n):
    """Limb for limb against tpu/ntt.py (tests/test_torch_ntt.py holds intt
    against it at 1, 2, 8, 256 and 4096 points, coset_intt at 8 and 256)."""
    n = 1 << log_n
    planar, t = both(ref_mont.FR, rand_elems(n, R, 60 + log_n))
    assert same(ntt.intt(t), ref_ntt.intt(planar))
    assert same(ntt.coset_intt(t), ref_ntt.coset_intt(planar))
