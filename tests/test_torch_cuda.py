"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the `cuda` marker and skips without a CUDA device
(the kernels have no CPU mode).  The file imports neither jax nor the JAX
package, so it runs on a machine that has neither; tests/conftest.py does
import jax, so on such a machine run it as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from plonkit_tpu_torch.backend import HostMSMContext
from plonkit_tpu_torch.backend_torch import FrVec, TorchBackend
from plonkit_tpu_torch.gpu import ec, field_kernels as fk
from plonkit_tpu_torch.gpu import mont, msm_kernels as mk, ntt, ntt_mxu
from plonkit_tpu_torch.gpu.msm import WINDOW_CHUNK, MSMContext
from plonkit_tpu_torch.srs import dev_srs_g1

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def rand_rows(spec, n, seed):
    """[n, 8] Montgomery rows of seeded random values, edges planted."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(n - 4)]
    return mont.to_tensor(spec.to_mont_np(vals + [0, 1, spec.p - 1, spec.p - 2]), "cpu")


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_field_kernels_match_plain(card, op):
    plain = {"mul": mont.mont_mul, "add": mont.add, "sub": mont.sub}[op]
    for spec in (mont.FR, mont.FQ):
        a = rand_rows(spec, 4096, 1).to(card)
        b = rand_rows(spec, 4096, 2).flip(0).contiguous().to(card)
        before = fk.launches[op]
        assert torch.equal(getattr(fk, op)(spec, a, b), plain(spec, a, b))
        assert fk.launches[op] == before + 1


def test_mont_conversions_match_plain_and_upload_once(card):
    """fk.to_mont, fk.from_mont and fk.mul_row on the card against gpu/mont.py's
    plain forms over Fr and Fq; once the fields' rows are on the card, a
    second conversion waits on the card for nothing and uploads nothing."""
    from plonkit_tpu_torch import profiling
    for spec in (mont.FR, mont.FQ):
        raw = rand_rows(spec, 4096, 6)             # < p: canonical rows too
        m = fk.to_mont(spec, raw.to(card))
        assert torch.equal(m.cpu(), mont.to_mont(spec, raw))
        assert torch.equal(fk.from_mont(spec, m).cpu(), raw)
        row = spec.row(12345, card)
        assert torch.equal(fk.mul_row(spec, m, row).cpu(),
                           mont.mont_mul(spec, m.cpu(), row.cpu().expand(4096, 8)))
        before = profiling.counts()
        back = fk.from_mont(spec, fk.to_mont(spec, m))
        after = profiling.counts()
        assert {k: after[k] - before[k] for k in ("device_waits", "h2d_bytes")} == {
            "device_waits": 0, "h2d_bytes": 0}
        assert torch.equal(back.cpu(), m.cpu())


def test_butterfly_dif_matches_plain(card):
    lo, hi, w = (rand_rows(mont.FR, 2048, s).to(card) for s in (3, 4, 5))
    u, v = ntt.butterfly_dif(lo, hi, w)
    assert torch.equal(u, mont.add(mont.FR, lo, hi))
    assert torch.equal(v, mont.mont_mul(mont.FR, w, mont.sub(mont.FR, lo, hi)))


def test_mul_add_matches_plain(card):
    for spec in (mont.FR, mont.FQ):
        a, b, c = (rand_rows(spec, 4096, s).to(card) for s in (11, 12, 13))
        before = fk.launches["mul_add"]
        assert torch.equal(fk.mul_add(spec, a, b, c), mont.mul_add(spec, a, b, c))
        assert fk.launches["mul_add"] == before + 1


def test_butterfly_matches_plain(card):
    """K5 on separate rows and on the even / odd rows of one buffer."""
    for spec in (mont.FR, mont.FQ):
        lo, hi, w = (rand_rows(spec, 2048, s).to(card) for s in (14, 15, 16))
        buf = torch.stack([lo, hi], dim=1).reshape(4096, 8)
        want = mont.butterfly(spec, lo, hi, w)
        for a, b in ((lo, hi), (buf[0::2], buf[1::2])):
            before = ntt.launches["butterfly"]
            got = ntt.butterfly(spec, a, b, w)
            assert all(torch.equal(g, x) for g, x in zip(got, want))
            assert ntt.launches["butterfly"] == before + 1


def test_dit_intt_on_the_card_matches_the_cpu(card):
    for log_n in (1, 2, 5, 11, 14):
        x = rand_rows(mont.FR, 1 << log_n, 17)[:1 << log_n]
        before = ntt.launches["butterfly"]
        assert torch.equal(ntt.intt(x.to(card)).cpu(), ntt.intt(x))
        assert ntt.launches["butterfly"] == before + log_n


def test_transforms_on_the_card_match_the_cpu(card):
    x = rand_rows(mont.FR, 4096, 6)
    for fn in (ntt.ntt, ntt.intt, ntt.coset_ntt, ntt.coset_intt,
               lambda t: ntt.coset_lde(t, 4)):
        assert torch.equal(fn(x.to(card)).cpu(), fn(x))


def test_backend_rounds_on_the_card_match_the_cpu(card):
    cpu, gpu = TorchBackend("cpu"), TorchBackend("cuda")
    vs = [rand_rows(mont.FR, 1024, 10 + i) for i in range(9)]

    def run(b, dev):
        v = [FrVec(t.to(dev)) for t in vs]
        z = b.permutation_grand_product(v[0], v[1:5], v[5:9], 3, 5, (1, 5, 7, 10))
        return [z.data.cpu(), b.divide_by_linear(v[0], 77).data.cpu(),
                b.batch_inverse(v[1]).data.cpu()], b.poly_eval_many(v[:3], 99)

    (rows_c, ev_c), (rows_g, ev_g) = run(cpu, "cpu"), run(gpu, card)
    assert all(torch.equal(a, b) for a, b in zip(rows_c, rows_g)) and ev_c == ev_g


SCAN_SIZES = (1, 2, 3, 4095, 4096, 4097, 3 * 4096 + 5, 40 * 1024 + 17)   # K12 tiles: 4096 rows


def scan_rows(spec, n, seed, zeros="none"):
    """[n, 8] Montgomery rows of seeded random values, zeros planted at the
    first row, the last row, every third row or everywhere."""
    rng = np.random.default_rng(seed)
    rows = spec.to_mont_np([int.from_bytes(rng.bytes(32), "little") % spec.p
                            for _ in range(n)])
    if zeros == "all":
        rows[:] = 0
    elif zeros == "first":
        rows[0] = 0
    elif zeros == "last":
        rows[-1] = 0
    elif zeros == "thirds":
        rows[::3] = 0
    return mont.to_tensor(rows, "cpu")


@pytest.mark.parametrize("op", ["mul", "add"])
def test_field_scan_matches_plain(card, op):
    """K12 in every direction and form at ragged n, against scan_plain."""
    for spec in (mont.FR, mont.FQ):
        for n in SCAN_SIZES:
            x = scan_rows(spec, n, 30 + n, "first").to(card)
            for reverse in (False, True):
                for exclusive in (False, True):
                    before = fk.launches["scan"]
                    got = fk.scan(spec, x, op, reverse, exclusive)
                    assert fk.launches["scan"] == before + 1
                    assert torch.equal(got, fk.scan_plain(spec, x, op, reverse, exclusive)), \
                        (spec.kernel_id, n, reverse, exclusive)


def test_field_scan_many_tiles_matches_plain(card):
    """K12 over 2^20 + 3 rows (257 tiles, the last of 3 rows): the
    look-back across many tiles, both directions."""
    x = scan_rows(mont.FR, (1 << 20) + 3, 40).to(card)
    for op, reverse, exclusive in (("mul", False, True), ("add", True, True),
                                   ("mul", True, False)):
        assert torch.equal(fk.scan(mont.FR, x, op, reverse, exclusive),
                           fk.scan_plain(mont.FR, x, op, reverse, exclusive))


@pytest.mark.parametrize("zeros", ["none", "first", "last", "thirds", "all"])
def test_batch_inverse_matches_plain(card, zeros):
    """Two K12 launches and one K13, no K1, against batch_inverse_plain."""
    for spec in (mont.FR, mont.FQ):
        for n in SCAN_SIZES:
            v = scan_rows(spec, n, 50 + n, zeros).to(card)
            before = dict(fk.launches)
            got = fk.batch_inverse(spec, v)
            assert (fk.launches["scan"] - before["scan"], fk.launches["inverse"]
                    - before["inverse"], fk.launches["mul"] - before["mul"]) == (2, 1, 0)
            assert torch.equal(got, fk.batch_inverse_plain(spec, v)), (spec.kernel_id, n)


def test_field_inverse_matches_plain(card):
    """K13 on edge values and random rows, one thread a row."""
    for spec in (mont.FR, mont.FQ):
        rows = torch.cat([mont.to_tensor(spec.to_mont_np([0, 1, 2, spec.p - 1, spec.p - 2]),
                                         "cpu"), scan_rows(spec, 59, 60)]).to(card)
        steps = torch.zeros(rows.shape[0], dtype=torch.int32, device=card)
        before = fk.launches["inverse"]
        got = fk.inverse(spec, rows, steps)
        assert fk.launches["inverse"] == before + 1
        assert torch.equal(got, mont.inverse(spec, rows))
        assert int(steps[0]) == 0 and int((steps[1:] & 0xFFFF).min()) > 0


def _msm_inputs(card, n, seed):
    """A device MSM context over n dev-SRS bases, and seeded scalars with
    a planted hot bucket (window 0, digit 3) and some zeros."""
    ctx = MSMContext(dev_srs_g1(n, 42), device=card)
    rng = np.random.default_rng(seed)
    scalars = [int.from_bytes(rng.bytes(32), "little") % mont.FR.p for _ in range(n)]
    scalars[:300] = [3] * 300
    scalars[300:400] = [0] * 100
    raw = mont.to_tensor(mont.FR.to_limbs_np(scalars), card)
    return ctx, scalars, raw


def _equal(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def _fold_levels_match(ctx, sums, seg_bucket):
    """Every K7r level against its plain version, each level fed the
    kernel's output; returns the bucket table."""
    bucket = seg_bucket
    for level in range(ctx.fold_levels):
        start, length, bucket = ctx._groups(bucket)
        last = (bucket, ctx.num_windows << ctx.c) if level == ctx.fold_levels - 1 else ()
        got = mk.segment_fold(sums, start, length, *last)
        assert _equal(got, mk.segment_fold_plain(sums, start, length, *last)), level
        sums = got
    return sums


def _window_levels_match(ctx, table):
    """Every K7w level against its plain version; returns the last level's
    (A, Q)."""
    k, t, p1, p2 = 1 << ctx.c, table, None, None
    while True:
        got = mk.window_sums(t, p1, p2, k, WINDOW_CHUNK)
        want = mk.window_sums_plain(t, p1, p2, k, WINDOW_CHUNK)
        assert _equal(got[0], want[0]) and _equal(got[1], want[1])
        assert (got[2] is None and want[2] is None) or _equal(got[2], want[2])
        t, a, q = got
        k = -(-k // WINDOW_CHUNK)
        if k == 1:
            return a, q
        p1, p2 = a, q


def test_msm_kernels_match_plain(card):
    ctx, _, raw = _msm_inputs(card, 1 << 12, 20)
    idx, seg_start, seg_len, seg_bucket = ctx._segments(ctx._sorted_keys(raw), 1 << 12)
    before = dict(mk.launches)
    sums = mk.bucket_sweep(ctx.table, idx, seg_start, seg_len)
    assert _equal(sums, mk.bucket_sweep_plain(ctx.table, idx, seg_start, seg_len))
    table = _fold_levels_match(ctx, sums, seg_bucket)
    assert _equal(table, ctx._bucket_table(sums, seg_bucket))
    q = tuple(a.roll(1, 0).contiguous() for a in table)
    assert _equal(mk.padd(table, q), mk.padd_plain(table, q))
    _window_levels_match(ctx, table)
    totals = ctx._window_totals(table)
    assert _equal(mk.combine(totals, ctx.c), mk.combine_plain(totals, ctx.c))
    assert all(mk.launches[k] > before[k] for k in mk.launches)


@pytest.mark.parametrize("skew", ["uniform", "zero_one"])
def test_segment_fold_levels_match_plain(card, skew):
    """Fold groups of 4 at 2^14: five K7r levels; the 0/1 scalars put
    ~2^13 entries (~256 segments) in one bucket of every window."""
    n = 1 << 14
    ctx = MSMContext(dev_srs_g1(n, 42), device=card, group=4)
    assert ctx.fold_levels == 5
    rng = np.random.default_rng(22)
    if skew == "uniform":
        scalars = [int.from_bytes(rng.bytes(32), "little") % mont.FR.p for _ in range(n)]
    else:
        scalars = [int(b) for b in rng.integers(0, 2, n)]
    raw = mont.to_tensor(mont.FR.to_limbs_np(scalars), card)
    idx, seg_start, seg_len, seg_bucket = ctx._segments(ctx._sorted_keys(raw), n)
    sums = mk.bucket_sweep(ctx.table, idx, seg_start, seg_len)
    table = _fold_levels_match(ctx, sums, seg_bucket)
    host = HostMSMContext.from_points(dev_srs_g1(n, 42))
    want = host.msm_rows(mont.FR.to_limbs_np(scalars).view(np.uint8))
    totals = ctx._window_totals(table)
    assert ec.to_affine_host(mk.combine(totals, ctx.c))[0] == want


def test_window_sums_levels_match_plain(card):
    """The three K7w levels of c = 12 on the bucket table of 2^12 uniform
    scalars (about a third of the rows empty)."""
    _, _, raw = _msm_inputs(card, 1 << 12, 23)
    ctx = MSMContext(dev_srs_g1(1 << 12, 42), device=card, c=12)
    idx, seg_start, seg_len, seg_bucket = ctx._segments(ctx._sorted_keys(raw), 1 << 12)
    table = ctx._bucket_table(mk.bucket_sweep(ctx.table, idx, seg_start, seg_len), seg_bucket)
    a, q = _window_levels_match(ctx, table)
    assert _equal(ctx._window_totals(table), mk.padd_plain(a, q))


def test_reduction_degenerate_inputs_match_plain(card):
    """K7r and K7w on P + P, P + (-P), infinity partners and empty groups."""
    pts = dev_srs_g1(4, 42)
    x, y, inf = ec.affine_from_host(pts, card)
    p = ec.jacobian_from_affine((x, y, inf))
    z = ec.infinity(4, card)
    # rows: P0 P0 -P0 inf P1 inf P2 -P2 P3 P3 P3 inf
    order = [(p, 0), (p, 0), (ec.neg(p), 0), (z, 0), (p, 1), (z, 1), (p, 2), (ec.neg(p), 2),
             (p, 3), (p, 3), (p, 3), (z, 3)]
    rows = tuple(torch.cat([src[i][j:j + 1] for src, j in order]).contiguous() for i in range(3))
    i64 = dict(dtype=torch.int64, device=card)
    start = torch.tensor([0, 1, 3, 4, 6, 8, 12, 11], **i64)
    length = torch.tensor([2, 2, 2, 1, 2, 3, 0, 1], **i64)
    dst = torch.tensor([5, 0, 1, 2, 3, 4, -1, 6], **i64)
    for extra in ((), (dst, 9)):
        assert _equal(mk.segment_fold(rows, start, length, *extra),
                      mk.segment_fold_plain(rows, start, length, *extra))
    for k_in, chunk in ((12, 4), (6, 4), (4, 2), (3, 16)):
        for p1, p2 in ((None, None), (rows, None), (None, rows), (rows, rows)):
            got = mk.window_sums(rows, p1, p2, k_in, chunk)
            want = mk.window_sums_plain(rows, p1, p2, k_in, chunk)
            assert _equal(got[0], want[0]) and _equal(got[1], want[1])
            assert (got[2] is None and want[2] is None) or _equal(got[2], want[2])


def test_padd_degenerate_lanes_match_plain(card):
    """P + P, P + (-P), P + inf, inf + Q, inf + inf on the card."""
    pts = dev_srs_g1(8, 42)
    x, y, inf = ec.affine_from_host(pts, card)
    p = ec.jacobian_from_affine((x, y, inf))
    z = ec.infinity(8, card)
    for q in (p, ec.neg(p), z):
        for a, b in ((p, q), (q, p), (z, z)):
            assert all(torch.equal(u, v) for u, v in zip(mk.padd(a, b), mk.padd_plain(a, b)))


def test_msm_on_the_card_matches_native(card):
    n = 1 << 14
    ctx, scalars, _ = _msm_inputs(card, n, 21)
    host = HostMSMContext.from_points(dev_srs_g1(n, 42))
    want = host.msm_rows(mont.FR.to_limbs_np(scalars).view(np.uint8))
    assert ctx.msm(scalars) == want
    v = mont.to_tensor(mont.FR.to_mont_np(scalars), card)
    assert ctx.msm_vec(v) == want


def test_small_commitments_on_the_card(card, tmp_path):
    """A backend on the card commits on the card at every size: a 2^10
    context is the device MSM, and its commitments equal the host's."""
    from plonkit_tpu_torch.api import gen_key_monomial_form
    from plonkit_tpu_torch.serialization import CrsHandle
    path = str(tmp_path / "srs_2pow10.key")
    gen_key_monomial_form(10).save(path)
    handle = CrsHandle(path)
    gpu = TorchBackend("cuda")
    ctx = gpu.msm_context_from_crs(handle, 1 << 10)
    assert isinstance(ctx, MSMContext)
    host = TorchBackend("cpu").msm_context_from_crs(handle, 1 << 10)
    v = rand_rows(mont.FR, 1 << 10, 30)
    before = mk.launches["bucket_sweep"]
    assert gpu.commit(ctx, FrVec(v.to(card))) == TorchBackend("cpu").commit(host, FrVec(v))
    assert mk.launches["bucket_sweep"] > before


def test_bucket_sweep_staged_table_matches_plain(card):
    """K6 stages each warp's indices: on the segments of 2^12 scalars with
    a hot bucket, against the plain version."""
    ctx, _, raw = _msm_inputs(card, 1 << 12, 24)
    idx, seg_start, seg_len, _ = ctx._segments(ctx._sorted_keys(raw), 1 << 12)
    before = mk.launches["bucket_sweep"]
    assert _equal(mk.bucket_sweep(ctx.table, idx, seg_start, seg_len),
                  mk.bucket_sweep_plain(ctx.table, idx, seg_start, seg_len))
    assert mk.launches["bucket_sweep"] == before + 1


_SWEEP_TABLE = """
import sys, torch
from plonkit_tpu_torch.gpu import msm_kernels as mk
e, n = 4096, 64
table = torch.zeros((n, 16), dtype=torch.int32, device="cuda")
idx = (torch.arange(e, device="cuda") % n).to(torch.int32)
start = {"runs": torch.arange(0, e, 32, device="cuda"),
         "reversed": torch.arange(0, e, 32, device="cuda").flip(0).contiguous(),
         "wide": torch.arange(0, e - 32, 40 * 32, device="cuda")}[sys.argv[1]]
mk.bucket_sweep(table, idx, start, torch.full_like(start, 32))
torch.cuda.synchronize()
print("swept")
"""


@pytest.mark.parametrize("kind", ["runs", "reversed", "wide"])
def test_bucket_sweep_rejects_segments_outside_the_warp_window(card, kind):
    """A table whose segments leave their warp's staged window (consecutive
    runs in reverse order, or runs 40 * 32 entries apart) stops K6 with a
    CUDA error instead of reading past the window; the same runs in order
    sweep.  Each runs in its own process, since the error ends the CUDA
    context."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    run = subprocess.run([sys.executable, "-c", _SWEEP_TABLE, kind], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=300)
    if kind == "runs":
        assert run.returncode == 0 and "swept" in run.stdout, run.stderr
    else:
        assert run.returncode != 0 and "swept" not in run.stdout
        assert "CUDA" in run.stderr or "cuda" in run.stderr, run.stderr


def test_batched_combine_matches_plain_and_single_launches(card):
    """K8 over 11 MSMs of 22 windows (c = 12) in one launch: equal to the
    plain version and to 11 single launches."""
    pts = dev_srs_g1(64, 42)
    x, y, inf = ec.affine_from_host(pts, card)
    p = ec.jacobian_from_affine((x, y, inf))
    q = mk.padd(p, tuple(a.roll(3, 0).contiguous() for a in p))       # Z != 1
    w = tuple(a.repeat(4, 1)[:11 * 22].contiguous() for a in q)       # 11 x 22 rows
    for a in w:
        a[22 * 4:22 * 4 + 5] = 0                                       # infinite windows
    before = mk.launches["combine"]
    got = mk.combine(w, 12, 11)
    assert mk.launches["combine"] == before + 1
    assert _equal(got, mk.combine_plain(w, 12, 11))
    for b in range(11):
        one = mk.combine(tuple(a[22 * b:22 * (b + 1)].contiguous() for a in w), 12)
        assert _equal(tuple(g[b:b + 1] for g in got), one), b


def test_msm_vec_end_many_on_the_card_matches_native(card):
    n = 1 << 12
    ctx = MSMContext(dev_srs_g1(n, 42), device=card)
    host = HostMSMContext.from_points(dev_srs_g1(n, 42))
    rng = np.random.default_rng(25)
    rows = [[int.from_bytes(rng.bytes(32), "little") % mont.FR.p for _ in range(n)],
            [int(b) for b in rng.integers(0, 2, n)], [7] * (n // 2)]
    before = mk.launches["combine"]
    handles = [ctx.msm_vec_begin(mont.to_tensor(mont.FR.to_mont_np(r), card)) for r in rows]
    got = ctx.msm_vec_end_many(handles)
    assert mk.launches["combine"] == before + 1
    assert got == [host.msm_rows(mont.FR.to_limbs_np(r).view(np.uint8)) for r in rows]


def test_device_srs_matches_serial_srs(card):
    """gpu/fixed_base on the card (32 K7 launches, the inversion by K12
    and K13, K1 for the rest) gives srs.py's points."""
    from plonkit_tpu_torch.gpu import fixed_base
    n = 1 << 12
    before = (mk.launches["padd"], fk.launches["mul"], fk.launches["scan"],
              fk.launches["inverse"])
    x, y, inf = fixed_base.gen_crs_g1_device(12, 42, device=card)
    assert mk.launches["padd"] == before[0] + fixed_base.NUM_WINDOWS
    assert fk.launches["mul"] > before[1]
    assert (fk.launches["scan"], fk.launches["inverse"]) == (before[2] + 2, before[3] + 1)
    pts = [None if i else (a, b) for a, b, i in
           zip(mont.FQ.from_limbs_np(x), mont.FQ.from_limbs_np(y), inf)]
    assert pts == dev_srs_g1(n, 42)


@pytest.mark.parametrize("method", ["fma_acc", "add_into", "mul_into", "add_scalar",
                                    "grand_product", "offload_onload"])
def test_extended_backend_methods_match_cpu(card, method):
    """The TorchBackend methods of the extended prover on the card against
    the same methods on the CPU (the plain versions)."""
    cpu, gpu = TorchBackend("cpu"), TorchBackend("cuda")
    vs = [rand_rows(mont.FR, 1 << 12, seed) for seed in (7, 8, 9)]

    def run(b, dev):
        acc, x, y = (FrVec(t.to(dev)) for t in vs)
        if method == "fma_acc":
            return b.fma_acc(acc, x, y)
        if method == "add_into":
            return b.add_into(acc, x)
        if method == "mul_into":
            return b.mul_into(acc, x)
        if method == "add_scalar":
            return b.add_scalar(x, 0xC0FFEE)
        if method == "grand_product":
            return b.grand_product(x)
        return b.onload(b.offload(x))
    before = dict(fk.launches)
    got = run(gpu, card)
    if method == "fma_acc":
        assert fk.launches["mul_add"] == before["mul_add"] + 1
    assert torch.equal(got.data.cpu(), run(cpu, "cpu").data)


@pytest.mark.parametrize("r,batch", [(16, 32), (128, 8192), (8, 3), (2, 1), (64, 16384),
                                     (256, 37)] + [(r, 1) for r in (4, 8, 16, 32, 64, 128, 256)])
def test_ntt_mxu_kernels_match_plain(card, r, batch):
    """K9, K10 and K11 at one level of the tensor-core NTT (the radix-16
    level of 512 points, with K padded to 544; the radix-128 level of 2^20
    points; a radix-8 transform of 3 columns, ragged in M and N; the
    radix-64 level of 2^20 points; radix 256 at a ragged N; every radix at
    N = 1, one column of a 128 x 256 tile) against their plain versions on
    the card, and the level's fold against the transform by the
    butterflies."""
    x = rand_rows(mont.FR, r * batch, 30 + r)[:r * batch].to(card).view(r, batch, 8)
    before = dict(ntt_mxu.launches)
    digits = ntt_mxu.balanced_digits(x)
    assert torch.equal(digits, ntt_mxu.balanced_digits_plain(x))
    table = ntt_mxu._dft_table(r, False, str(card))
    assert torch.equal(table, ntt_mxu._dft_table(r, False, "cpu").to(card))
    g = ntt_mxu.dft_product(table, digits)
    assert torch.equal(g, ntt_mxu.dft_product_plain(table, digits))
    y = ntt_mxu.fold_redc(g)
    assert torch.equal(y, ntt_mxu.fold_redc_plain(g))
    assert torch.equal(y, ntt.ntt_batched(x))
    assert all(ntt_mxu.launches[k] > before[k] for k in before)


def test_balanced_digits_table_build_matches_plain(card):
    """K9 at r = 1 with the column count of the radix-256 table build
    (256^2 * 33 elements, _dft_table's call), 512 columns a block."""
    rng = np.random.default_rng(31)
    rows = rng.integers(0, 1 << 32, size=(256 * 256 * 33, 8), dtype=np.uint64).astype(np.uint32)
    rows[:, 7] %= np.uint32(mont.FR.p32[7])
    x = mont.to_tensor(rows, card).view(1, -1, 8)
    assert torch.equal(ntt_mxu.balanced_digits(x), ntt_mxu.balanced_digits_plain(x))


def test_dft_product_one_tile_matches_plain(card):
    """K10 on a 16 x 8 x 32 product: one corner of a 128 x 256 tile, the
    rest of its TMA boxes zero-filled."""
    gen = torch.Generator().manual_seed(5)
    a = torch.randint(-128, 128, (16, 32), generator=gen, dtype=torch.int8)
    x = torch.randint(-128, 128, (8, 32), generator=gen, dtype=torch.int8)
    g = ntt_mxu.dft_product(a.to(card), x.to(card))
    assert torch.equal(g.cpu(), ntt_mxu.dft_product_plain(a, x))


@pytest.mark.parametrize("log_n", [9, 12, 16])
def test_ntt_mxu_transforms_match_butterflies(card, log_n):
    n = 1 << log_n
    x = rand_rows(mont.FR, n, 40 + log_n).to(card)
    c = x[:n // 4].contiguous()
    assert torch.equal(ntt_mxu.ntt_mxu(x), ntt.ntt(x))
    assert torch.equal(ntt_mxu.intt_mxu(x), ntt.intt(x))
    assert torch.equal(ntt_mxu.coset_ntt_mxu(x), ntt.coset_ntt(x))
    assert torch.equal(ntt_mxu.coset_intt_mxu(x), ntt.coset_intt(x))
    assert torch.equal(ntt_mxu.coset_lde_mxu(c, 4), ntt.coset_lde(c, 4))


def _planted_butterflies(card, n):
    """K14's inputs at n lanes of SRS points summed in pairs (Z != 1), with
    lo, hi or both at infinity, lo = [w]hi, lo = -[w]hi and w = 1 and 0
    planted in lanes 0-6."""
    from plonkit_tpu_torch.fields import FR_MODULUS
    from plonkit_tpu_torch.gpu import group_ntt
    pts = dev_srs_g1(2 * n, 42)
    rng = np.random.default_rng(23)
    w = [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS for _ in range(n)]
    w[5], w[6] = 1, 0
    jac = ec.jacobian_from_affine(ec.affine_from_host(pts, card))
    p = mk.padd(jac, tuple(a.roll(1, 0).contiguous() for a in jac))     # Z != 1
    lo = tuple(a[:n].clone() for a in p)
    hi = tuple(a[n:].contiguous() for a in p)
    wr = mont.to_tensor(mont.FR.to_limbs_np(w), card)
    for a in lo:
        a[0], a[2] = 0, 0                                   # lo infinite
    for a in hi:
        a[1], a[2] = 0, 0                                   # hi infinite, both
    t3 = group_ntt.g1_butterfly_plain(ec.infinity(n, card), hi, wr)[0]
    for a, b, c in zip(lo, t3, ec.neg(t3)):
        a[3], a[4] = b[3], c[4]                             # lo = [w]hi, lo = -[w]hi
    return pts, lo, hi, wr


def test_group_ntt_kernels_match_plain(card):
    """K14 g1_butterfly and K15 g1_scale against their plain versions on the
    card, Jacobian rows limb for limb (lo, hi or both at infinity, lo =
    [w]hi, lo = -[w]hi, w = 0 and 1 planted), then the Lagrange form of 64
    SRS points made on the card equal to the CPU's."""
    from plonkit_tpu_torch.gpu import group_ntt
    n = 64
    pts, lo, hi, wr = _planted_butterflies(card, n)
    before = dict(group_ntt.launches)
    got = group_ntt.g1_butterfly(lo, hi, wr)
    want = group_ntt.g1_butterfly_plain(lo, hi, wr)
    assert all(torch.equal(g, x) for gs, xs in zip(got, want) for g, x in zip(gs, xs))
    assert all(torch.equal(g, x) for g, x in zip(group_ntt.g1_scale(hi, 2 ** 255 + 3),
                                                  group_ntt.g1_scale_plain(hi, 2 ** 255 + 3)))
    assert group_ntt.launches == {"g1_butterfly": before["g1_butterfly"] + 1,
                                  "g1_scale": before["g1_scale"] + 1,
                                  "g1_points_in": before["g1_points_in"]}
    x, y = (mont.FQ.to_limbs_np([q[c] for q in pts[:n]]) for c in (0, 1))
    inf = np.zeros(n, dtype=bool)
    on_card = group_ntt.group_intt(x, y, inf, card)
    assert group_ntt.launches["g1_butterfly"] == before["g1_butterfly"] + 1 + 6
    assert all(np.array_equal(a, b)
               for a, b in zip(on_card, group_ntt.group_intt(x, y, inf, "cpu")))


# every (lane group, product split) the kernels take
GROUP_SPLITS = [(1, 1), (2, 1), (4, 1), (4, 2)]


@pytest.mark.parametrize("lanes", [64, 1 << 11])
def test_group_ntt_every_lane_group_matches_plain(card, lanes, monkeypatch):
    """K14 at `lanes` lanes (the planted cases above) and, at 2^11 lanes,
    K15 by 1/2^12 on the 2^12 points lo and hi, in every lane group and
    product split the kernels take, each forced through
    group_ntt.lane_group and group_ntt.product_split, against their plain
    versions limb for limb."""
    from plonkit_tpu_torch.fields import fr_inv
    from plonkit_tpu_torch.gpu import group_ntt
    _, lo, hi, wr = _planted_butterflies(card, lanes)
    want = group_ntt.g1_butterfly_plain(lo, hi, wr)
    scale = lanes == 1 << 11
    if scale:
        p, s = tuple(torch.cat([a, b]) for a, b in zip(lo, hi)), fr_inv(2 * lanes)
        want_scale = group_ntt.g1_scale_plain(p, s)
    for g, sp in GROUP_SPLITS:
        monkeypatch.setattr(group_ntt, "lane_group", lambda lanes, sms, g=g: g)
        monkeypatch.setattr(group_ntt, "product_split", lambda lanes, sms, sp=sp: sp)
        got = group_ntt.g1_butterfly(lo, hi, wr)
        assert all(torch.equal(a, b) for gs, xs in zip(got, want) for a, b in zip(gs, xs)), (g, sp)
        if scale:
            assert all(torch.equal(a, b)
                       for a, b in zip(group_ntt.g1_scale(p, s), want_scale)), (g, sp)


@pytest.mark.parametrize("lanes", [1, 37, 1000])
def test_group_ntt_ragged_launches_match_one_thread(card, lanes, monkeypatch):
    """A launch whose last warp runs past its lanes (those threads run the
    last lane and store nothing): K14 and K15 in every lane group and
    product split equal to one thread a lane, limb for limb."""
    from plonkit_tpu_torch.gpu import group_ntt
    _, lo, hi, wr = _planted_butterflies(card, max(lanes, 8))
    lo, hi, wr = tuple(a[:lanes] for a in lo), tuple(a[:lanes] for a in hi), wr[:lanes]
    got = {}
    for g, sp in GROUP_SPLITS:
        monkeypatch.setattr(group_ntt, "lane_group", lambda lanes, sms, g=g: g)
        monkeypatch.setattr(group_ntt, "product_split", lambda lanes, sms, sp=sp: sp)
        got[g, sp] = (torch.cat([t for half in group_ntt.g1_butterfly(lo, hi, wr) for t in half]),
                      torch.cat(group_ntt.g1_scale(hi, 2 ** 200 + 7)))
    for pair, (k14, k15) in got.items():
        assert torch.equal(k14, got[1, 1][0]) and torch.equal(k15, got[1, 1][1]), pair


def test_split_product_matches_k1_mul(card):
    """The split product alone (group_ntt.split_mul, two threads a product)
    against K1's mul over Fq: 0, 1, p - 1, p - 2, limbs of 0xffffffff below
    p and seeded values, each against every edge, and squares."""
    from plonkit_tpu_torch.gpu import group_ntt
    q = mont.FQ.p
    edge = [0, 1, q - 1, q - 2, q - 3, (1 << 224) - 1, (1 << 253) - 1, (q >> 32) << 32,
            q - (1 << 32), (1 << 128) - 1]
    rng = np.random.default_rng(31)
    vals = [int.from_bytes(rng.bytes(32), "little") % q for _ in range(1023)] + [q - 1]
    a = mont.to_tensor(mont.FQ.to_limbs_np(edge * len(edge) + vals), card)
    b = mont.to_tensor(mont.FQ.to_limbs_np([e for e in edge for _ in edge] + vals[::-1]), card)
    for x, y in ((a, b), (b, a), (a, a)):
        assert torch.equal(group_ntt.split_mul(x, y), fk.mul(mont.FQ, x, y))


def test_group_ntt_lane_groups_follow_the_launch(card, monkeypatch):
    """A 2^12 group_intt takes lane groups in each of its 12 K14 launches and
    its K15 (g1_lane_groups counts 13), and splits the products of the
    launches that product_split gives 2 (its 12 stages of 2^11 lanes on the
    H100); a K14 launch of 32 lanes for each warp scheduler of the card
    takes one thread a lane and splits none, and gives the bits of the
    4-thread form on the same lanes."""
    from plonkit_tpu_torch import profiling
    from plonkit_tpu_torch.gpu import group_ntt
    from plonkit_tpu_torch.gpu.fixed_base import gen_crs_g1_device
    x, y, inf = gen_crs_g1_device(16, 42, card)
    before = profiling.counts()
    group_ntt.group_intt(x[:1 << 12], y[:1 << 12], inf[:1 << 12], card)
    after = profiling.counts()
    assert after["launches.g1_butterfly"] - before["launches.g1_butterfly"] == 12
    assert after["launches.g1_scale"] - before["launches.g1_scale"] == 1
    assert after["g1_lane_groups"] - before["g1_lane_groups"] == 13
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    split = [group_ntt.product_split(n, sms) > 1 for n in [1 << 11] * 12 + [1 << 12]]
    assert after["g1_split_products"] - before["g1_split_products"] == sum(split)
    if sms == 132:
        assert sum(split) == 12
    lanes = 32 * group_ntt.SCHEDULERS_PER_SM * sms
    assert group_ntt.lane_group(lanes, sms) == 1 < group_ntt.lane_group(lanes - 1, sms)
    base = tuple(fk.to_mont(mont.FQ, mont.to_tensor(c[:2 * lanes], card)) for c in (x, y)) \
        + (mont.FQ.const(1, 2 * lanes, card),)
    p = mk.padd(base, tuple(a.roll(1, 0).contiguous() for a in base))
    lo, hi = tuple(a[:lanes] for a in p), tuple(a[lanes:] for a in p)
    w = fk.from_mont(mont.FR, ntt.powers(5, lanes, card))
    got = group_ntt.g1_butterfly(lo, hi, w)
    assert profiling.counts()["g1_lane_groups"] == after["g1_lane_groups"]
    assert profiling.counts()["g1_split_products"] == after["g1_split_products"]
    monkeypatch.setattr(group_ntt, "lane_group", lambda lanes, sms: 4)
    want = group_ntt.g1_butterfly(lo, hi, w)
    assert profiling.counts()["g1_lane_groups"] == after["g1_lane_groups"] + 1
    assert all(torch.equal(a, b) for gs, xs in zip(got, want) for a, b in zip(gs, xs))


@pytest.mark.parametrize("lanes,g", [(1 << 11, 4), (1 << 19, 1)])
def test_group_ntt_in_place_stage_matches_plain(card, lanes, g):
    """K14 as group_intt launches it, reading the even and odd rows of one
    [3, 2N, 8] buffer in place and writing the two halves of another,
    against its plain version limb for limb: every lane at 2^11 lanes (g =
    4 on the H100), one lane in 128 at 2^19 (g = 1: the plain ladder over
    all 2^19 lanes would take minutes).  Stage 0's twiddles of the 2N-point
    inverse transform, w = 0 planted, lo and hi at infinity in lanes 3, 4."""
    from plonkit_tpu_torch.fields import fr_inv, get_domain_omega
    from plonkit_tpu_torch.gpu import group_ntt
    from plonkit_tpu_torch.gpu.fixed_base import gen_crs_g1_device
    n = 2 * lanes
    x, y, _ = gen_crs_g1_device(n.bit_length() - 1, 42, card)
    base = tuple(fk.to_mont(mont.FQ, mont.to_tensor(c, card)) for c in (x, y)) \
        + (mont.FQ.const(1, n, card),)
    buf = torch.stack(mk.padd(base, tuple(a.roll(1, 0).contiguous() for a in base)))  # Z != 1
    buf[:, 6] = 0                                       # lane 3's lo at infinity
    buf[:, 9] = 0                                       # lane 4's hi at infinity
    w = fk.from_mont(mont.FR, ntt.powers(fr_inv(get_domain_omega(n)), lanes, card))
    w[5] = 0
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert group_ntt.lane_group(lanes, sms) == g
    from plonkit_tpu_torch import profiling
    split = profiling.counts()["g1_split_products"]
    spare = torch.empty_like(buf)
    lo, hi = group_ntt.g1_butterfly(tuple(c[0::2] for c in buf), tuple(c[1::2] for c in buf), w,
                                    out=tuple(spare))
    grew = profiling.counts()["g1_split_products"] - split
    assert grew == (group_ntt.product_split(lanes, sms) > 1)
    at = torch.cat([torch.arange(8, device=card),
                    torch.arange(8, lanes, max(1, lanes >> 12), device=card)])
    want = group_ntt.g1_butterfly_plain(tuple(c[0::2][at] for c in buf),
                                        tuple(c[1::2][at] for c in buf), w[at])
    got = (tuple(c[at] for c in lo), tuple(c[at] for c in hi))
    assert all(torch.equal(a, b) for gs, xs in zip(got, want) for a, b in zip(gs, xs))


@pytest.fixture(scope="module")
def monomial_key_2p12():
    """The 2^12 tau = 42 monomial key made on the card, after one Lagrange
    key from it (kernels built, the process's CUDA state warm)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from plonkit_tpu_torch.api import crs_lagrange_form
    from plonkit_tpu_torch.curve import G2_GEN, g2_mul
    from plonkit_tpu_torch.gpu.fixed_base import gen_crs_g1_device
    from plonkit_tpu_torch.serialization import CrsLimbs
    key = CrsLimbs(*gen_crs_g1_device(12, 42, "cuda"), [G2_GEN, g2_mul(G2_GEN, 42)])
    crs_lagrange_form(key, 1 << 12)
    torch.cuda.synchronize()
    return key


def test_lagrange_key_waits_are_torch_syncs(monomial_key_2p12, monkeypatch):
    """profiling's device_waits over one 2^12 key equals the synchronizations
    torch reports under set_sync_debug_mode("warn"), every warning recorded,
    with each torch.cuda.synchronize call that gave no warning of its own
    (torch's debug mode flags implicit syncs; an explicit one may pass
    silently)."""
    import warnings
    from plonkit_tpu_torch import profiling
    from plonkit_tpu_torch.api import crs_lagrange_form
    synchronize, silent = torch.cuda.synchronize, []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def counted(*args, **kwargs):
            seen = len(caught)
            out = synchronize(*args, **kwargs)
            if len(caught) == seen:
                silent.append(1)
            return out
        monkeypatch.setattr(torch.cuda, "synchronize", counted)
        before = profiling.counts()["device_waits"]
        torch.cuda.set_sync_debug_mode("warn")
        try:
            crs_lagrange_form(monomial_key_2p12, 1 << 12)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        waits = profiling.counts()["device_waits"] - before
    reported = [f"{w.filename}:{w.lineno} {w.message}" for w in caught
                if "called a synchronizing CUDA operation" in str(w.message)]
    print(f"device_waits {waits}; torch: {len(reported)} warnings, {len(silent)} "
          f"synchronize calls without one")
    assert waits == len(reported) + len(silent), "\n".join(reported)


def test_lagrange_key_h2d_bytes_are_the_traced_copies(monomial_key_2p12, tmp_path):
    """profiling's h2d_bytes over one 2^12 key equals the bytes of the
    Memcpy HtoD events in a torch.profiler trace of it."""
    import json
    from plonkit_tpu_torch import profiling
    from plonkit_tpu_torch.api import crs_lagrange_form
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        before = profiling.counts()["h2d_bytes"]
        crs_lagrange_form(monomial_key_2p12, 1 << 12)
        counted = profiling.counts()["h2d_bytes"] - before
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "key.json"))
    with open(tmp_path / "key.json") as f:
        events = json.load(f)["traceEvents"]
    copies = [e["args"]["bytes"] for e in events if e.get("ph") == "X"
              and e.get("cat") == "gpu_memcpy" and e["name"].startswith("Memcpy HtoD")]
    print(f"h2d_bytes {counted}; traced: {len(copies)} HtoD copies, {sum(copies)} bytes")
    assert copies and counted == sum(copies)


def test_lagrange_key_counts_one_upload_and_one_launch_each_of_k16_k17(monomial_key_2p12):
    """One 2^12 key: one upload of 266,272 bytes (the points' x and y rows,
    the root w^-1, inf's bytes), 2 device waits (the upload, the
    read-back), one K16 g1_points_in and one K17 field_powers."""
    from plonkit_tpu_torch import profiling
    from plonkit_tpu_torch.api import crs_lagrange_form
    keys = ("h2d_bytes", "device_waits", "launches.g1_points_in", "launches.field_powers")
    before = profiling.counts()
    crs_lagrange_form(monomial_key_2p12, 1 << 12)
    after = profiling.counts()
    assert {k: after[k] - before[k] for k in keys} == dict(zip(keys, (266_272, 2, 1, 1)))


@pytest.mark.parametrize("log_n", [12, 20])
def test_points_in_and_field_powers_match_plain(card, log_n):
    """K16 g1_points_in on 2^log_n SRS points (every 7th at infinity) and
    K17 field_powers of the 2^log_n domain's w^-1 (2^(log_n - 1) powers)
    against their plain versions run on the card, every row limb for limb;
    and against the chains they replace, K16 on a sample of 4,096 points:
    to_mont, Z = one, the mask, the gather by ntt.bit_reversal; K17 on
    power_table's canonical powers."""
    from plonkit_tpu_torch.fields import fr_inv, get_domain_omega
    from plonkit_tpu_torch.gpu import group_ntt
    from plonkit_tpu_torch.gpu.fixed_base import gen_crs_g1_device
    n = 1 << log_n
    x, y, inf = gen_crs_g1_device(log_n, 42, card)
    inf = np.asarray(inf, dtype=bool).copy()
    inf[::7] = True
    base = fr_inv(get_domain_omega(n))
    xy, root, at_inf = group_ntt._upload_in(x, y, inf, base, card)
    before = (group_ntt.launches["g1_points_in"], fk.launches["field_powers"])
    pts = group_ntt.g1_points_in(xy, at_inf)
    tw = fk.field_powers(mont.FR, root, n // 2)
    assert (group_ntt.launches["g1_points_in"], fk.launches["field_powers"]) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(pts, group_ntt.g1_points_in_plain(xy, at_inf))
    assert torch.equal(tw, fk.field_powers_plain(mont.FR, root, n // 2))
    at = np.random.default_rng(log_n).choice(n, size=min(n, 4096), replace=False)
    src = ntt.bit_reversal(n)[at]                     # row at of the buffer holds point src
    k = len(at)
    want = fk.to_mont(mont.FQ, torch.cat([xy[:n][torch.from_numpy(src).to(card)],
                                          xy[n:][torch.from_numpy(src).to(card)]]))
    keep = torch.from_numpy(~inf[src]).to(card)[:, None]
    one = mont.FQ.one(card).expand(k, mont.NLIMBS)
    for c, v in enumerate((want[:k], want[k:], one)):
        assert torch.equal(pts[c][torch.from_numpy(at).to(card)], torch.where(keep, v, 0))
    table = mont.to_tensor(ntt.power_table(base, n // 2, montgomery=False), card)
    assert torch.equal(tw, ntt.powers_from(table, n // 2))


def test_lagrange_key_at_a_fresh_domain_counts_the_same_twice(monomial_key_2p12):
    """A key of 2^10 points, a domain no other test here derives, then the
    same key again: both calls count the same device_waits and h2d_bytes,
    each at most 4 waits, and give the same limbs, so no table that depends
    on the domain is carried from one call to the next."""
    from plonkit_tpu_torch import profiling
    from plonkit_tpu_torch.api import crs_lagrange_form
    counted, keys = [], []
    for _ in range(2):
        before = profiling.counts()
        keys.append(crs_lagrange_form(monomial_key_2p12, 1 << 10).g1_limbs())
        after = profiling.counts()
        counted.append({k: after[k] - before[k] for k in ("device_waits", "h2d_bytes")})
    print(f"first call {counted[0]}; second {counted[1]}")
    assert counted[0] == counted[1] and counted[0]["device_waits"] <= 4
    assert all(np.array_equal(a, b) for a, b in zip(*keys))
