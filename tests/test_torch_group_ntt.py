"""The port's group NTT (plonkit_tpu_torch/gpu/group_ntt.py) on the CPU,
through the plain versions of K14 g1_butterfly and K15 g1_scale, exact
bytes everywhere:

- the GLV constants: beta and lambda a matching pair ([lambda]G = (beta
  G.x, G.y) through the port's curve), the short basis, and csrc/group_ntt.cu's
  limbs of them; the split k = k1 + k2 lambda mod r within its bound on
  seeded scalars, edge values and the 2^20 domain's twiddles; the signed
  recoding rebuilding each half from odd digits in [-15, 15];
- the plain K14 and K15 (the GLV ladder) against the JAX package's host
  curve arithmetic (g1_mul, g1_add, g1_neg), lane by lane after the affine
  conversion, on seeded Jacobian lanes with the planted cases of
  chip_smoke.py's phase 3 (lo, hi or both at infinity, lo = [w]hi, lo =
  -[w]hi, w = 0, 1 and r - 1), on random twiddles and on twiddles w^-j of
  the 2^20 domain; the plain K14 refuses a twiddle of r or more, which the
  card's split does not take;
- api.crs_lagrange_form(..., device="cpu") against the JAX package's
  plonkit_tpu.api.crs_lagrange_form (its host python group NTT), the saved
  keys byte for byte, at domains 2, 4, 16 and 64, on the first points of
  the in-repo tau = 42 key and on a key of points from seeded random
  scalars (with the point at infinity among them);
- at 2^8, the MSM of seeded values over the Lagrange key equals the MSM
  of their inverse transform over the monomial key (the native Pippenger);
- without a card, the default crs_lagrange_form, `dump-lagrange` and
  `setup -p 10` raise rather than run on the CPU.
"""

import os
import re

import numpy as np
import pytest
import torch

from plonkit_tpu import api as ref_api
from plonkit_tpu.curve import G1_GEN, g1_add, g1_mul, g1_neg
from plonkit_tpu.serialization import Crs as RefCrs
from plonkit_tpu_torch import api, cli, curve, native
from plonkit_tpu_torch.backend import HostMSMContext
from plonkit_tpu_torch.fields import FQ_MODULUS as Q, FR_MODULUS as R, fr_inv, get_domain_omega
from plonkit_tpu_torch.gpu import build, ec, group_ntt
from plonkit_tpu_torch.gpu.mont import FR, to_tensor
from plonkit_tpu_torch.serialization import (CrsHandle, load_crs_g1_limbs,
                                             save_crs_g1_limbs)

from test_torch_prove import KEY, ref_crs

SEED = 20261018
DOMAINS = (2, 4, 16, 64)
MSM_LOG2 = 8


@pytest.fixture(autouse=True, scope="module")
def _env(tmp_path_factory):
    old_threads, old_build = torch.get_num_threads(), native.BUILD_DIR
    torch.set_num_threads(1)
    native.BUILD_DIR = str(tmp_path_factory.mktemp("native_build"))
    yield
    torch.set_num_threads(old_threads)
    native.BUILD_DIR = old_build


def affine(jac):
    return ec.to_affine_host(jac)


def jacobian(points):
    """Host affine points -> a Jacobian batch with Z != 1 where it can: each
    finite point P as 2P - P through the plain complete add."""
    aff = ec.affine_from_host(points, "cpu")
    p = ec.jacobian_from_affine(aff)
    return ec.add(ec.double(p), ec.neg(p))


def scalar_rows(values):
    return to_tensor(FR.to_limbs_np(values), "cpu")


@pytest.fixture(scope="module")
def tau_key(tmp_path_factory):
    """The first 2^8 points of the in-repo tau = 42 key, as a key file."""
    path = str(tmp_path_factory.mktemp("tau") / "tau.key")
    n = 1 << MSM_LOG2
    save_crs_g1_limbs(path, *load_crs_g1_limbs(KEY, n), CrsHandle(KEY).g2_monomial_bases)
    return path


@pytest.fixture(scope="module")
def foreign_key(tmp_path_factory):
    """64 points of seeded random scalars, 0 (infinity) and 1 among them."""
    rng = np.random.default_rng(SEED)
    scalars = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(64)]
    scalars[5], scalars[9] = 0, 1
    crs = RefCrs([g1_mul(G1_GEN, s) for s in scalars], ref_crs(KEY, 1).g2_monomial_bases)
    path = str(tmp_path_factory.mktemp("foreign") / "foreign.key")
    crs.save(path)
    return path


def _twiddles(rng, n, kind):
    if kind == "random":
        return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    w_inv = fr_inv(get_domain_omega(1 << 20))
    return [pow(w_inv, int(j), R) for j in rng.integers(1, 1 << 19, size=n)]


@pytest.mark.parametrize("kind", ["random", "domain twiddles"])
def test_plain_butterfly_equals_host_curve(kind):
    rng = np.random.default_rng(SEED + 1)
    n = 12
    bases = [g1_mul(G1_GEN, int.from_bytes(rng.bytes(32), "little") % R) for _ in range(2 * n)]
    w = _twiddles(rng, n, kind)
    lo, hi = bases[:n], bases[n:]
    lo[0] = None                                        # lo infinite
    hi[1] = None                                        # hi infinite
    lo[2] = hi[2] = None                                # both
    lo[3] = g1_mul(hi[3], w[3])                         # lo - [w]hi is infinity
    lo[4] = g1_neg(g1_mul(hi[4], w[4]))                 # lo + [w]hi is infinity
    w[5] = 1                                            # a twiddle of k = 0
    w[6] = 0
    w[7] = R - 1
    before = dict(group_ntt.launches)
    a, b = group_ntt.g1_butterfly(jacobian(lo), jacobian(hi), scalar_rows(w))
    assert group_ntt.launches == before                 # plain versions: no launch
    t = [g1_mul(h, s) for h, s in zip(hi, w)]
    assert affine(a) == [g1_add(p, q) for p, q in zip(lo, t)]
    assert affine(b) == [g1_add(p, g1_neg(q)) for p, q in zip(lo, t)]
    assert affine(a)[3] == g1_mul(hi[3], 2 * w[3] % R) and affine(b)[3] is None
    assert affine(a)[4] is None


@pytest.mark.parametrize("log_n", [4, 6, 8])
def test_plain_butterfly_in_place_equals_slices_and_cat(log_n):
    """A stage as group_intt runs it, K14's plain version reading the even
    and odd rows of one [3, n, 8] buffer in place and writing the halves of
    another (out=), equals the stage over contiguous copies of the even and
    odd rows with its halves put together by cat, limb for limb, over n
    lanes of seeded points (one at infinity) and random twiddles with 1 and
    0 among them."""
    n = 1 << log_n
    rng = np.random.default_rng(SEED + log_n)
    pts = [g1_mul(G1_GEN, int.from_bytes(rng.bytes(32), "little") % R) for _ in range(n)]
    pts[3] = None
    buf = torch.stack(jacobian(pts))
    w = _twiddles(rng, n // 2, "random")
    w[1], w[2] = 1, 0
    w = scalar_rows(w)
    spare = torch.full_like(buf, -1)
    lo, hi = group_ntt.g1_butterfly(tuple(c[0::2] for c in buf), tuple(c[1::2] for c in buf), w,
                                    out=tuple(spare))
    a, b = group_ntt.g1_butterfly(tuple(c[0::2].contiguous() for c in buf),
                                  tuple(c[1::2].contiguous() for c in buf), w)
    want = torch.stack([torch.cat([x, y]) for x, y in zip(a, b)])
    assert torch.equal(spare, want)
    assert all(t.data_ptr() == c.data_ptr() for t, c in zip(lo, spare))
    assert all(t.data_ptr() == c[n // 2:].data_ptr() for t, c in zip(hi, spare))


def test_butterfly_refuses_operands_it_cannot_read_in_place():
    """K14's operands: lo and hi one whole number of rows apart, all six
    alike; out a triple of 2N rows that shares no memory with them."""
    p = torch.stack(jacobian([G1_GEN] * 4))
    w = scalar_rows([1, 1])
    even, odd = tuple(c[0::2] for c in p), tuple(c[1::2] for c in p)
    with pytest.raises(ValueError):                     # hi contiguous, lo strided
        group_ntt.g1_butterfly(even, tuple(c.contiguous() for c in odd), w)
    with pytest.raises(ValueError):                     # out is the input
        group_ntt.g1_butterfly(even, odd, w, out=tuple(p))
    with pytest.raises(ValueError):                     # out of N rows, not 2N
        group_ntt.g1_butterfly(even, odd, w, out=tuple(torch.empty_like(c) for c in even))
    sparse = torch.zeros((3, 2, 2 * 8), dtype=torch.int32)[:, :, ::2]
    with pytest.raises(ValueError):                     # limbs not dense
        group_ntt.g1_butterfly(tuple(sparse), tuple(sparse), w)


@pytest.mark.parametrize("w", [R, 2 * R + 1, (1 << 256) - 1])
def test_plain_butterfly_rejects_a_non_canonical_twiddle(w):
    hi = jacobian([G1_GEN, G1_GEN])
    with pytest.raises(ValueError):
        group_ntt.g1_butterfly(hi, hi, scalar_rows([1, w]))


@pytest.mark.parametrize("s", [0, 1, 2, 15, 16, 17, fr_inv(1 << 20), R - 1, 1 << 255])
def test_plain_scale_equals_host_curve(s):
    rng = np.random.default_rng(SEED + 2)
    pts = [g1_mul(G1_GEN, int.from_bytes(rng.bytes(32), "little") % R) for _ in range(5)]
    pts[2] = None
    got = affine(group_ntt.g1_scale(jacobian(pts), s))
    assert got == [g1_mul(p, s % R) if p is not None else None for p in pts]


def _points_in_chain(xy, inf):
    """The points-in chain group_intt ran before K16: to_mont into one
    [3, n, 8] buffer, the Z fill with Montgomery one, masked_fill_ where
    inf is set, index_select by ntt.bit_reversal."""
    from plonkit_tpu_torch.gpu import field_kernels as fk, ntt
    from plonkit_tpu_torch.gpu.mont import FQ, NLIMBS
    n = inf.shape[0]
    pts = torch.empty((3, n, NLIMBS), dtype=torch.int32)
    fk.to_mont(FQ, xy, out=pts[:2].view(2 * n, NLIMBS))
    pts[2] = FQ.one("cpu")
    rev = torch.from_numpy(ntt.bit_reversal(n))
    return pts.masked_fill_(inf[None, :, None], 0).index_select(1, rev)


@pytest.mark.parametrize("at_inf", [False, True])
@pytest.mark.parametrize("log_n", range(9))
def test_plain_points_in_equals_the_chain(log_n, at_inf):
    """K16's plain version (group_ntt.g1_points_in on CPU rows) gives the
    chain's [3, n, 8] buffer limb for limb, with no launch: seeded
    canonical x and y, 0 and q - 1 among them, and with at_inf every third
    point at infinity."""
    from plonkit_tpu_torch.gpu.mont import FQ
    n = 1 << log_n
    rng = np.random.default_rng(SEED + log_n)
    vals = [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(2 * n)]
    vals[0], vals[-1] = 0, Q - 1
    xy = to_tensor(FQ.to_limbs_np(vals), "cpu")
    inf = torch.zeros(n, dtype=torch.bool)
    if at_inf:
        inf[::3] = True
    before = dict(group_ntt.launches)
    got = group_ntt.g1_points_in(xy, inf)
    assert group_ntt.launches == before
    assert torch.equal(got, _points_in_chain(xy, inf))


@pytest.mark.parametrize("log_n", [0, 4, 12])
def test_upload_in_is_one_buffer_of_points_root_and_flags(log_n):
    """_upload_in's one buffer holds the x and y rows, the canonical root
    and inf's bytes, padded to whole words, and nothing else: 266,272
    bytes at 2^12."""
    n = 1 << log_n
    rng = np.random.default_rng(SEED + 40 + log_n)
    x, y = (rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint32) for _ in range(2))
    inf = rng.random(n) < 0.25
    base = fr_inv(get_domain_omega(max(n, 2)))
    xy, root, at_inf = group_ntt._upload_in(x, y, inf, base, "cpu")
    assert xy.untyped_storage().nbytes() == (2 * n + 1) * 32 + -(-n // 4) * 4
    if n == 1 << 12:
        assert xy.untyped_storage().nbytes() == 266_272
    assert np.array_equal(xy.numpy().view(np.uint32), np.concatenate([x, y]))
    assert FR.from_limbs_np(root.numpy().view(np.uint32)) == [base]
    assert at_inf.dtype == torch.bool and np.array_equal(at_inf.numpy(), inf)


def test_points_in_refuses_what_it_cannot_read():
    rows = torch.zeros((6, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        group_ntt.g1_points_in(rows, torch.zeros(3, dtype=torch.bool))       # n = 3
    with pytest.raises(ValueError):
        group_ntt.g1_points_in(rows[:4], torch.zeros(4, dtype=torch.bool))   # 2 rows for 4
    with pytest.raises(ValueError):
        group_ntt.g1_points_in(rows[:4], torch.zeros(2, dtype=torch.uint8))


def test_glv_beta_lambda_match():
    """phi(G) = (beta G.x, G.y) is [lambda]G, and both are primitive cube
    roots of unity; the basis vectors are in the lattice, of determinant r
    and under 2^127."""
    assert curve.g1_mul(curve.G1_GEN, curve.GLV_LAMBDA) == (
        curve.GLV_BETA * curve.G1_GEN[0] % Q, curve.G1_GEN[1])
    assert g1_mul(G1_GEN, curve.GLV_LAMBDA) == (curve.GLV_BETA * G1_GEN[0] % Q, G1_GEN[1])
    for root, m in ((curve.GLV_BETA, Q), (curve.GLV_LAMBDA, R)):
        assert root != 1 and pow(root, 3, m) == 1
    basis = ((curve.GLV_A1, curve.GLV_B1), (curve.GLV_A2, curve.GLV_B2))
    assert all((a + b * curve.GLV_LAMBDA) % R == 0 for a, b in basis)
    assert curve.GLV_A1 * curve.GLV_B2 - curve.GLV_A2 * curve.GLV_B1 == R
    assert all(abs(c) < 1 << 127 for v in basis for c in v)
    assert curve.GLV_BOUND < 1 << 127


def _split_scalars():
    rng = np.random.default_rng(SEED + 4)
    w_inv = fr_inv(get_domain_omega(1 << 20))
    return ([0, 1, 2, curve.GLV_LAMBDA, R - 1, (R - 1) // 2, (R + 1) // 2, (1 << 255) % R,
             fr_inv(1 << 20), R - curve.GLV_LAMBDA]
            + [int.from_bytes(rng.bytes(32), "little") % R for _ in range(2000)]
            + [pow(w_inv, int(j), R) for j in rng.integers(0, 1 << 19, size=500)])


def test_glv_split_within_its_bound():
    for k in _split_scalars():
        k1, k2 = curve.glv_split(k)
        assert (k1 + k2 * curve.GLV_LAMBDA - k) % R == 0, k
        assert max(abs(k1), abs(k2)) <= curve.GLV_BOUND, k
    assert curve.glv_split(1) == (1, 0) and curve.glv_split(curve.GLV_LAMBDA) == (0, 1)


def test_ladder_digits_and_table():
    """glv_recode: each half rebuilt from 32 odd signed digits in [-15, 15]
    (plus 1 where it is even); glv_scalars' nibbles and flags are those of
    glv_recode; K15's kernel argument holds the same words."""
    ks = _split_scalars()[:300]
    for k in ks:
        es, evens = group_ntt.glv_recode(k)
        for h, e, even in zip(curve.glv_split(k), es, evens):
            d = [2 * ((e >> (4 * j)) & 15) - 15 for j in range(group_ntt.GLV_WINDOWS)]
            assert all(x % 2 == 1 and -15 <= x <= 15 for x in d)
            assert sum(x << (4 * j) for j, x in enumerate(d)) == h + even
            assert even == (h % 2 == 0)
    nib, even = group_ntt.glv_scalars(ks, "cpu")
    assert nib.shape == (len(ks), 2, group_ntt.GLV_WINDOWS)
    for i, k in enumerate(ks):
        es, evens = group_ntt.glv_recode(k)
        assert [sum(int(x) << (4 * j) for j, x in enumerate(nib[i, h])) for h in (0, 1)] == list(es)
        assert tuple(even[i].tolist()) == evens
    words = group_ntt.scale_args(fr_inv(1 << 20))
    (e1, e2), (even1, even2) = group_ntt.glv_recode(fr_inv(1 << 20))
    assert [sum(int(w) << (32 * j) for j, w in enumerate(words[4 * h:4 * h + 4]))
            for h in (0, 1)] == [e1, e2]
    assert words[8:].tolist() == [even1, even2, 0] and group_ntt.scale_args(R + 1)[10] == 1


def _cuda_words(src: str, name: str) -> int:
    """The little-endian 32-bit words of the array `name` in the source, as
    one int."""
    body = re.search(r"\b" + name + r"\[\d+\] = \{([^}]*)\}", src).group(1)
    words = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
    return sum(w << (32 * j) for j, w in enumerate(words))


def test_glv_constants_in_cuda_source():
    """csrc/group_ntt.cu's split constants and beta are curve.py's."""
    with open(os.path.join(build.CSRC, "group_ntt.cu")) as f:
        src = f.read()
    assert _cuda_words(src, "g1") == curve.GLV_G1
    assert _cuda_words(src, "g2") == curve.GLV_G2
    assert _cuda_words(src, "a1") == curve.GLV_A1 == curve.GLV_B2
    assert _cuda_words(src, "a2") == curve.GLV_A2
    assert _cuda_words(src, "b1") == -curve.GLV_B1
    beta = re.search(r"Fe glv_beta\(\) \{(.*?)return", src, re.S).group(1)
    limbs = {int(i): int(v, 16)
             for i, v in re.findall(r"r\.v\[(\d)\] = 0x([0-9a-f]+)u", beta)}
    assert sum(limbs[j] << (32 * j) for j in range(8)) == curve.GLV_BETA * (1 << 256) % Q
    assert f"kWindows = {group_ntt.GLV_WINDOWS};" in src and f"kTable = {group_ntt.TABLE};" in src


@pytest.mark.parametrize("lanes,g", [(1 << 19, 1), (1 << 15, 1), (1 << 14, 2), (1 << 13, 4),
                                     (1 << 12, 4), (1 << 11, 4), (64, 4), (1, 4)])
def test_lane_group_on_132_sms(lanes, g):
    """The lane group of a launch on an H100's 132 SMs (528 warp
    schedulers): a thread a lane at group_intt's 2^19-lane stages of 2^20
    points, 4 at the 2^12 key's 2^11 lanes and its K15's 2^12 points."""
    assert group_ntt.lane_group(lanes, 132) == g


def test_lane_group_edges_and_the_kernels_groups():
    """A thread a lane from 32 lanes a warp scheduler up; below, the
    smallest group that gives every scheduler a warp, at most 4; a card
    of fewer SMs takes a thread a lane sooner; csrc/group_ntt.cu launches
    every group lane_group gives."""
    full = 32 * group_ntt.SCHEDULERS_PER_SM * 132
    assert group_ntt.lane_group(full, 132) == 1 and group_ntt.lane_group(full - 1, 132) == 2
    assert group_ntt.lane_group(full // 2, 132) == 2 and group_ntt.lane_group(full // 2 - 1, 132) == 4
    assert group_ntt.lane_group(1 << 11, 16) == 1 and group_ntt.lane_group(1 << 11, 32) == 2
    with open(os.path.join(build.CSRC, "group_ntt.cu")) as f:
        src = f.read()
    for g in group_ntt.LANE_GROUPS:
        assert f"case {g}: return launch(std::integral_constant<int, {g}>{{}});" in src


@pytest.mark.parametrize("lanes,s", [(1 << 19, 1), (1 << 15, 1), (1 << 14, 1), (1 << 13, 1),
                                     (1 << 12, 1), (1 << 11, 2), (64, 2), (1, 2)])
def test_product_split_on_132_sms(lanes, s):
    """The product split of a launch on an H100's 132 SMs: two threads a
    product at the 2^12 key's 2^11-lane stages (g = 4, 512 warps for 528
    schedulers), one from 2^12 lanes up (its K15's 2^12 points, where the
    split's 1,024 warps would double up on the schedulers), and at the
    2^19-lane stages of 2^20 points."""
    assert group_ntt.product_split(lanes, 132) == s


def test_product_split_edges_and_the_kernels_pairs():
    """Two threads a product while 8 threads a lane give each warp
    scheduler at most one warp, one beyond; a card of fewer SMs splits
    later; the split only ever comes with lane groups of 4, and
    csrc/group_ntt.cu launches every (g, S) the two rules give."""
    edge = 32 * group_ntt.SCHEDULERS_PER_SM * 132 // 8
    assert group_ntt.product_split(edge, 132) == 2 and group_ntt.product_split(edge + 1, 132) == 1
    assert group_ntt.product_split(1 << 11, 16) == 1 and group_ntt.product_split(1 << 8, 16) == 2
    pairs = {(group_ntt.lane_group(n, sms), group_ntt.product_split(n, sms))
             for sms in (1, 16, 78, 108, 114, 132, 144) for n in [1 << k for k in range(21)]
             + [3, 1000, 2111, 2113, 4223, 4225, 16895]}
    assert pairs == {(1, 1), (2, 1), (4, 1), (4, 2)}
    assert set(group_ntt.PRODUCT_SPLITS) == {s for _, s in pairs}
    with open(os.path.join(build.CSRC, "group_ntt.cu")) as f:
        src = f.read()
    for g, s in pairs:
        if s == 1:
            assert f"case {g}: return launch(std::integral_constant<int, {g}>{{}});" in src
        else:
            assert (f"if (group == {g} && split == {s})\n        return launch("
                    f"std::integral_constant<int, {g}>{{}}, std::integral_constant<int, {s}>{{}});"
                    in src)


def test_split_mul_runs_on_the_card_only():
    """The split product has no CPU form: a CPU tensor raises (its plain
    version is gpu/mont.mont_mul)."""
    rows = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        group_ntt.split_mul(rows, rows)


def _key_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("which", ["tau", "foreign"])
@pytest.mark.parametrize("domain", DOMAINS)
def test_crs_lagrange_form_equals_jax(which, domain, tau_key, foreign_key, tmp_path):
    path = tau_key if which == "tau" else foreign_key
    got = api.crs_lagrange_form(CrsHandle(path), domain, device="cpu")
    assert got.num_g1 == domain
    got.save(str(tmp_path / "port.key"))
    ref_api.crs_lagrange_form(RefCrs.load(path), domain).save(str(tmp_path / "jax.key"))
    assert _key_bytes(tmp_path / "port.key") == _key_bytes(tmp_path / "jax.key")


def test_crs_lagrange_form_takes_a_crs_of_points(foreign_key, tmp_path):
    """A Crs of host points (as Crs.load reads a key) gives the same key as
    its file read as limb rows."""
    from plonkit_tpu_torch.serialization import Crs
    api.crs_lagrange_form(Crs.load(foreign_key), 2, device="cpu").save(str(tmp_path / "a.key"))
    api.crs_lagrange_form(CrsHandle(foreign_key), 2, device="cpu").save(str(tmp_path / "b.key"))
    assert _key_bytes(tmp_path / "a.key") == _key_bytes(tmp_path / "b.key")
    with pytest.raises(ValueError):
        api.crs_lagrange_form(CrsHandle(foreign_key), 128, device="cpu")
    with pytest.raises(ValueError):
        api.crs_lagrange_form(CrsHandle(foreign_key), 12, device="cpu")


def test_lagrange_msm_equals_monomial_msm(tau_key):
    """sum_i v_i L_i(tau) G = sum_j c_j tau^j G for c = intt(v): the
    Lagrange key commits to values as the monomial key to coefficients."""
    n = 1 << MSM_LOG2
    handle = CrsHandle(tau_key)
    lagrange = api.crs_lagrange_form(handle, n, device="cpu")
    rng = np.random.default_rng(SEED + 3)
    v = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    w_inv = fr_inv(get_domain_omega(n))
    pows = [pow(w_inv, k, R) for k in range(n)]
    n_inv = fr_inv(n)
    c = [n_inv * sum(vi * pows[i * j % n] for i, vi in enumerate(v)) % R for j in range(n)]
    by_values = HostMSMContext.from_limbs(*lagrange.g1_limbs(n), threads=1)
    by_coeffs = HostMSMContext.from_limbs(*handle.g1_limbs(n), threads=1)
    got = by_values.msm_rows(FR.to_limbs_np(v).view(np.uint8))
    assert got is not None
    assert got == by_coeffs.msm_rows(FR.to_limbs_np(c).view(np.uint8))


def test_without_a_card_the_defaults_raise(tau_key, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        api.crs_lagrange_form(CrsHandle(tau_key), 4)
    circuit = os.path.join(os.path.dirname(KEY), "circuit.r1cs.json")
    out = str(tmp_path / "lagrange.key")
    with pytest.raises(RuntimeError):
        cli.main(["dump-lagrange", "-m", tau_key, "-l", out, "-c", circuit])
    with pytest.raises(RuntimeError):
        cli.main(["setup", "-p", "10", "-m", str(tmp_path / "setup.key")])
    assert not os.listdir(tmp_path)
