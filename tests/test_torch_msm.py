"""The port's MSM (plonkit_tpu_torch/gpu/msm.py over the plain versions of
K6, K7, K7r, K7w and K8 in gpu/msm_kernels.py) on the CPU, against the JAX package's python
Pippenger (plonkit_tpu.curve.g1_msm_host) and the port's native one
(native.bn254_g1_msm), on the same 2^10 bases of the tau = 42 dev SRS and
the same seeded scalars.  Points are compared as affine host points:
exactly.  Each scalar set stresses one part of the design: zero digits
that drop out, one hot bucket per window (0/1, constant, p - 1), a bucket
spanning more than four K6 segments, and fewer scalars than bases.  Narrow
fold groups make the K7r fold run three levels and more at 2^10, and the
K7w window sums are held against host sums at c = 4, 5 and 12."""

import numpy as np
import pytest
import torch

from plonkit_tpu.curve import g1_msm_host as ref_msm
from plonkit_tpu_torch import native
from plonkit_tpu_torch.curve import G1_GEN, g1_add, g1_double, g1_mul, g1_neg
from plonkit_tpu_torch.fields import FR_MODULUS as R
from plonkit_tpu_torch.gpu import ec, msm_kernels as mk
from plonkit_tpu_torch.gpu.mont import FQ, FR, to_tensor
from plonkit_tpu_torch.gpu.msm import SEGMENT, WINDOW_CHUNK, MSMContext, window_bits
from plonkit_tpu_torch.srs import dev_srs_g1

N = 1 << 10
HOT = 5 * SEGMENT + 7        # entries of the planted long bucket


@pytest.fixture(autouse=True, scope="module")
def _env(tmp_path_factory):
    old_threads, old_build = torch.get_num_threads(), native.BUILD_DIR
    torch.set_num_threads(1)
    native.BUILD_DIR = str(tmp_path_factory.mktemp("native_build"))
    yield
    torch.set_num_threads(old_threads)
    native.BUILD_DIR = old_build


@pytest.fixture(scope="module")
def bases():
    return dev_srs_g1(N, 42)


@pytest.fixture(scope="module")
def ctx(bases):
    return MSMContext(bases, device="cpu")


def uniform(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]


def scalar_set(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "uniform":
        return uniform(rng, N)
    if name == "zeros":
        return [0] * N
    if name == "ones":
        return [1] * N
    if name == "zero_one":
        return [int(b) for b in rng.integers(0, 2, N)]
    if name == "p_minus_1":
        return [R - 1] * N
    if name == "single":
        out = [0] * N
        out[N // 3] = uniform(rng, 1)[0]
        return out
    if name == "fewer":
        return uniform(rng, N // 3)
    if name == "long_bucket":
        # HOT scalars share digit 5 of window 0 and are zero elsewhere
        return [5] * HOT + uniform(rng, N - HOT)
    raise KeyError(name)


def native_msm(bases, scalars):
    rows = b"".join(p[0].to_bytes(32, "little") + p[1].to_bytes(32, "little") for p in bases)
    pts = np.frombuffer(rows, dtype=np.uint8).reshape(-1, 64)[:len(scalars)]
    return native.bn254_g1_msm(np.ascontiguousarray(pts),
                               FR.to_limbs_np([s % R for s in scalars]).view(np.uint8))


SETS = ["uniform", "zeros", "ones", "zero_one", "p_minus_1", "single", "fewer", "long_bucket"]


@pytest.mark.parametrize("name", SETS)
def test_msm_matches_host_pippengers(bases, ctx, name):
    scalars = scalar_set(name)
    got = ctx.msm(scalars)
    assert got == native_msm(bases, scalars)
    assert got == ref_msm(bases[:len(scalars)], scalars)


def test_long_bucket_spans_segments(ctx):
    """The planted bucket really is cut into more than four segments."""
    scalars = scalar_set("long_bucket")
    raw = to_tensor(FR.to_limbs_np(scalars), "cpu")
    _, seg_start, seg_len, seg_bucket = ctx._segments(ctx._sorted_keys(raw), N)
    hot = seg_bucket == 5            # window 0, digit 5
    entries = sum(1 for s in scalars if s & ((1 << ctx.c) - 1) == 5)
    assert entries >= HOT
    assert int(hot.sum()) == -(-entries // SEGMENT) > 4
    assert int(seg_len[hot].sum()) == entries and int(seg_len.max()) == SEGMENT


def test_msm_vec_and_queued_commitments(bases, ctx):
    """msm_vec and msm_vec_begin / msm_vec_end over Montgomery Fr rows
    (fewer than the bases), queued two at a time."""
    rng = np.random.default_rng(11)
    a = uniform(rng, N // 4)
    b = [int(v) for v in rng.integers(0, 3, N // 2)]
    va, vb = (to_tensor(FR.to_mont_np(s), "cpu") for s in (a, b))
    assert ctx.msm_vec(va) == native_msm(bases, a)
    handles = [ctx.msm_vec_begin(v) for v in (vb, va)]
    assert [ctx.msm_vec_end(h) for h in handles] == [native_msm(bases, b),
                                                     native_msm(bases, a)]


def test_bucket_table_and_weighted_reduction(bases, ctx):
    """The segment fold gives every bucket sum S_k, and the K7 rounds give
    sum_k k * S_k per window: both against python sums over host points."""
    rng = np.random.default_rng(3)
    scalars = [int(v) for v in rng.integers(0, 1 << 12, N)]      # windows 0-2
    scalars[:HOT] = [7] * HOT
    raw = to_tensor(FR.to_limbs_np(scalars), "cpu")
    idx, seg_start, seg_len, seg_bucket = ctx._segments(ctx._sorted_keys(raw), N)
    sums = mk.bucket_sweep(ctx.table, idx, seg_start, seg_len)
    table = ctx._bucket_table(sums, seg_bucket)
    width = 1 << ctx.c
    want = {}
    for p, s in zip(bases, scalars):
        for w in range(3):
            d = (s >> (ctx.c * w)) & (width - 1)
            if d:
                want[w * width + d] = g1_add(want.get(w * width + d), p)
    got = ec.to_affine_host(table)
    assert {k: v for k, v in enumerate(got) if v is not None} == want
    totals = ec.to_affine_host(ctx._window_totals(table))
    for w in range(ctx.num_windows):
        expect = None
        for k in range(1, width):
            if w * width + k in want:
                expect = g1_add(expect, g1_mul(want[w * width + k], k))
        assert totals[w] == expect


@pytest.mark.parametrize("group,name", [(2, "long_bucket"), (2, "zero_one"), (3, "fewer"),
                                        (4, "single")])
def test_msm_with_narrow_fold_groups(bases, group, name):
    """Fold groups of 2-4 partial sums: the K7r fold runs 3-5 levels at
    2^10, and buckets of one segment copy through every level."""
    ctx = MSMContext(bases, device="cpu", group=group)
    assert ctx.fold_levels == {2: 5, 3: 4, 4: 3}[group]
    scalars = scalar_set(name)
    got = ctx.msm(scalars)
    assert got == native_msm(bases, scalars)
    assert got == ref_msm(bases[:len(scalars)], scalars)


def test_bucket_table_takes_every_fold_level(bases):
    """With groups of 2 the planted bucket's 6 segment sums need three of
    the five levels; every bucket sum S_k still equals the host's."""
    ctx = MSMContext(bases, device="cpu", group=2)
    rng = np.random.default_rng(4)
    scalars = [int(v) for v in rng.integers(0, 1 << 8, N)]             # windows 0-1
    scalars[:HOT] = [9] * HOT
    raw = to_tensor(FR.to_limbs_np(scalars), "cpu")
    idx, seg_start, seg_len, seg_bucket = ctx._segments(ctx._sorted_keys(raw), N)
    assert int((seg_bucket == 9).sum()) > 4
    table = ctx._bucket_table(mk.bucket_sweep(ctx.table, idx, seg_start, seg_len), seg_bucket)
    width = 1 << ctx.c
    want = {}
    for p, s in zip(bases, scalars):
        for w in range(2):
            d = (s >> (ctx.c * w)) & (width - 1)
            if d:
                want[w * width + d] = g1_add(want.get(w * width + d), p)
    got = ec.to_affine_host(table)
    assert {k: v for k, v in enumerate(got) if v is not None} == want


def _host_table(rng, c, fill):
    """A bucket table for every window of width c, its rows drawn from
    +-v G for 24 random v (so P + P and P + (-P) meet in the chains), and
    the scalar of each row.  fill "every": no empty row; "sparse": a third
    of the rows empty, and an empty chunk in each window at K7w's first
    level and, at c = 12, at its second."""
    ctx = MSMContext([G1_GEN] * 16, device="cpu", c=c)
    rows = ctx.num_windows << c
    vals = [int(v) for v in rng.integers(1, 1 << 62, 24)]
    vals += [R - v for v in vals]
    pick = rng.integers(0, len(vals), rows)
    scal = [vals[i] for i in pick]
    if fill == "sparse":
        width = 1 << c
        for r in range(rows):
            k = r % width
            if rng.random() < 1 / 3 or WINDOW_CHUNK <= k < 2 * WINDOW_CHUNK or \
                    (c >= 9 and WINDOW_CHUNK ** 2 <= k < 2 * WINDOW_CHUNK ** 2):
                scal[r] = 0
    pts = {v: g1_mul(G1_GEN, v) for v in set(vals)}
    aff = ec.affine_from_host([pts[v] if v else None for v in scal], "cpu")
    return ctx, ec.jacobian_from_affine(aff), scal


@pytest.mark.parametrize("c,fill", [(4, "every"), (4, "sparse"), (5, "sparse"),
                                    (12, "every"), (12, "sparse")])
def test_window_sums_against_host(c, fill):
    """sum_k k * S_k per window through the K7w levels and the closing K7,
    against (sum_k k * s_k) G for the rows' scalars s_k."""
    rng = np.random.default_rng(40 + c)
    ctx, table, scal = _host_table(rng, c, fill)
    width = 1 << c
    got = ec.to_affine_host(ctx._window_totals(table))
    for w in range(ctx.num_windows):
        e = sum(k * scal[w * width + k] for k in range(width)) % R
        assert got[w] == (g1_mul(G1_GEN, e) if e else None)


def _host_pts(rng, n):
    """n host points, a few of them infinity, equal or opposite."""
    pts = [g1_mul(G1_GEN, int(v)) for v in rng.integers(1, 1 << 62, n)]
    pts[1], pts[2], pts[4] = pts[0], g1_neg(pts[3]), None
    return pts


def _host_sum(pts):
    acc = None
    for p in pts:
        acc = g1_add(acc, p)
    return acc


def test_segment_fold_plain_matches_host_loop():
    rng = np.random.default_rng(8)
    pts = _host_pts(rng, 12)
    jac = ec.jacobian_from_affine(ec.affine_from_host(pts, "cpu"))
    start = torch.tensor([0, 2, 3, 7, 12], dtype=torch.int64)
    length = torch.tensor([2, 1, 4, 5, 0], dtype=torch.int64)
    want = [_host_sum(pts[s:s + n]) for s, n in zip(start.tolist(), length.tolist())]
    assert ec.to_affine_host(mk.segment_fold_plain(jac, start, length)) == want
    dst = torch.tensor([3, 0, -1, 6, -1], dtype=torch.int64)
    got = ec.to_affine_host(mk.segment_fold_plain(jac, start, length, dst, 8))
    assert got == [want[1], None, None, want[0], None, None, want[3], None]


def test_window_sums_plain_matches_host_loop():
    """One K7w level: 2 windows of 6 items in chunks of 4 (the second
    chunk of each window partial)."""
    rng = np.random.default_rng(9)
    k_in, chunk = 6, 4
    pts = [_host_pts(rng, 2 * k_in) for _ in range(3)]
    jac = [ec.jacobian_from_affine(ec.affine_from_host(p, "cpu")) for p in pts]
    t, a, q = (ec.to_affine_host(x) for x in mk.window_sums_plain(*jac, k_in, chunk))
    _, _, q1 = mk.window_sums_plain(jac[0], jac[1], None, k_in, chunk)
    assert mk.window_sums_plain(jac[0], None, None, k_in, chunk)[2] is None
    for w in range(2):
        for j in range(2):
            lo = w * k_in + j * chunk
            rows = range(lo, min(lo + chunk, (w + 1) * k_in))
            c = w * 2 + j
            total = _host_sum([pts[0][r] for r in rows])
            assert t[c] == (g1_mul(total, chunk) if total else None)
            assert a[c] == _host_sum([g1_mul(pts[0][r], r - lo) for r in rows])
            assert q[c] == _host_sum([pts[1][r] for r in rows] + [pts[2][r] for r in rows])
            assert ec.to_affine_host(tuple(x[c:c + 1] for x in q1))[0] == \
                _host_sum([pts[1][r] for r in rows])


def test_combine_matches_host_horner():
    rng = np.random.default_rng(5)
    num, c = 6, 4
    pts = [g1_mul(G1_GEN, int(rng.integers(1, 1 << 60))) for _ in range(num)]
    pts[2] = None
    zs = [int(rng.integers(1, 1 << 60)) for _ in range(num)]
    jac = [(0, 0, 0) if p is None else (p[0] * z * z % FQ.p, p[1] * z ** 3 % FQ.p, z)
           for p, z in zip(pts, zs)]
    w = tuple(to_tensor(FQ.to_mont_np([t[i] for t in jac]), "cpu") for i in range(3))
    expect = None
    for p in reversed(pts):
        for _ in range(c):
            expect = g1_double(expect) if expect is not None else None
        expect = g1_add(expect, p)
    assert ec.to_affine_host(mk.combine(w, c)) == [expect]


def test_wrappers_take_the_plain_version_on_the_cpu(ctx):
    before = dict(mk.launches)
    p = ec.infinity(4, "cpu")
    assert all(bool((a == 0).all()) for a in mk.padd(p, p))
    assert all(bool((a == 0).all()) for a in mk.combine(p, 3))
    empty = torch.zeros(0, dtype=torch.int64)
    assert all(a.shape == (0, 8) for a in mk.bucket_sweep(
        ctx.table, torch.zeros(0, dtype=torch.int32), empty, empty))
    assert all(a.shape == (0, 8) for a in mk.segment_fold(p, empty, empty))
    assert all(bool((a == 0).all()) for a in mk.window_sums(p, None, p, 2, 2)[1])
    assert mk.launches == before
    with pytest.raises(ValueError):
        mk.segment_fold(p, empty, empty, dst=empty)
    with pytest.raises(ValueError):
        mk.window_sums(p, None, None, 3, 2)
    with pytest.raises(ValueError):
        mk.window_sums(p, None, None, 2, 3)
    with pytest.raises(ValueError):
        mk.bucket_sweep(ctx.table, torch.zeros(3, dtype=torch.int64), empty, empty)
    with pytest.raises(ValueError):
        mk.padd(p, tuple(a[:2] for a in p))
    with pytest.raises(ValueError):
        mk.combine(tuple(a.to(torch.int64) for a in p), 3)


def test_window_width_and_key_packing(bases):
    assert [window_bits(1 << k) for k in (4, 10, 13, 16, 20, 22)] == [4, 4, 5, 8, 12, 12]
    assert MSMContext(bases[:64], device="cpu").num_windows == 64
    # the bucket and the index must fit one int64 sort key
    with pytest.raises(ValueError):
        MSMContext(bases[:64], device="cpu", c=60)
