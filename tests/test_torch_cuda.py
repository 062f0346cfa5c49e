"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the `cuda` marker and skips without a CUDA device
(the kernels have no CPU mode).  The file imports neither jax nor the JAX
package, so it runs on a machine that has neither; tests/conftest.py does
import jax, so on such a machine run it as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from plonkit_tpu_torch.backend import HostMSMContext
from plonkit_tpu_torch.backend_torch import FrVec, TorchBackend
from plonkit_tpu_torch.gpu import ec, field_kernels as fk
from plonkit_tpu_torch.gpu import mont, msm_kernels as mk, ntt
from plonkit_tpu_torch.gpu.msm import MSMContext
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


def test_msm_kernels_match_plain(card):
    ctx, _, raw = _msm_inputs(card, 1 << 12, 20)
    idx, seg_start, seg_len, seg_bucket = ctx._segments(ctx._sorted_keys(raw), 1 << 12)
    before = dict(mk.launches)
    sums = mk.bucket_sweep(ctx.table, idx, seg_start, seg_len)
    assert all(torch.equal(a, b) for a, b in zip(
        sums, mk.bucket_sweep_plain(ctx.table, idx, seg_start, seg_len)))
    table = ctx._bucket_table(sums, seg_bucket)
    q = tuple(a.roll(1, 0).contiguous() for a in table)
    assert all(torch.equal(a, b) for a, b in zip(mk.padd(table, q), mk.padd_plain(table, q)))
    totals = ctx._window_totals(table)
    assert all(torch.equal(a, b) for a, b in zip(mk.combine(totals, ctx.c),
                                                 mk.combine_plain(totals, ctx.c)))
    assert all(mk.launches[k] > before[k] for k in mk.launches)


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
