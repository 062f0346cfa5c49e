"""K8 combine over a batch of MSMs, the queued end of the device MSM, and
the segment-table invariant that K6's index staging relies on, on the CPU
(plain versions).

`combine(w, c, batch)` over B stacks of window totals is held limb for
limb against B single-MSM calls, and each stack, as an affine point,
against the JAX package's Horner combine (plonkit_tpu/tpu/msm.py
`_combine_body`, run eagerly) at a small W and c.  `msm_vec_end_many` and
`TorchBackend("cpu").commit_many` over a device MSMContext on the CPU give
the JAX package's host MSM (plonkit_tpu/curve.py `g1_msm_host`) of each
vector, and the points of one `msm_vec_end` or one `commit` per vector.
Inputs are made from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonkit_tpu.curve import g1_msm_host
from plonkit_tpu.tpu import ec as ref_ec
from plonkit_tpu.tpu import msm as ref_msm
from plonkit_tpu.tpu.mont import FQ as REF_FQ
from plonkit_tpu_torch.backend_torch import FrVec, TorchBackend
from plonkit_tpu_torch.curve import G1_GEN, g1_mul
from plonkit_tpu_torch.fields import FQ_MODULUS as Q
from plonkit_tpu_torch.fields import FR_MODULUS as R
from plonkit_tpu_torch.gpu import ec, msm_kernels as mk
from plonkit_tpu_torch.gpu.mont import FQ, FR, NLIMBS, to_tensor
from plonkit_tpu_torch.gpu.msm import SEGMENT, MSMContext
from plonkit_tpu_torch.srs import dev_srs_g1

W, C = 3, 4          # windows a stack and window width of the batch tests


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def jacobian_ints(rng, n):
    """n Jacobian (X, Y, Z) int triples of random points with random Z,
    every fifth one infinity (all zeros)."""
    out = []
    for i in range(n):
        if i % 5 == 3:
            out.append((0, 0, 0))
            continue
        x, y = g1_mul(G1_GEN, int(rng.integers(1, 1 << 62)))
        z = int(rng.integers(1, 1 << 62))
        out.append((x * z * z % Q, y * z ** 3 % Q, z))
    return out


def port_rows(triples):
    return tuple(to_tensor(FQ.to_mont_np([t[i] for t in triples]), "cpu") for i in range(3))


@pytest.mark.parametrize("batch", [1, 3, 11])
def test_batched_combine_equals_single_calls(batch):
    """combine over B stacks gives, limb for limb, the B points of B
    single-MSM combines."""
    rng = np.random.default_rng(100 + batch)
    w = port_rows(jacobian_ints(rng, batch * W))
    got = mk.combine(w, C, batch)
    assert all(a.shape == (batch, NLIMBS) for a in got)
    for b in range(batch):
        one = mk.combine(tuple(a[b * W:(b + 1) * W].contiguous() for a in w), C)
        assert all(torch.equal(g[b:b + 1], o) for g, o in zip(got, one)), b


def test_batched_combine_matches_jax_horner():
    """Each stack of a batch of 3, as an affine point, against the JAX
    package's window combine on the same Jacobian stack."""
    rng = np.random.default_rng(7)
    triples = jacobian_ints(rng, 3 * W)
    got = ec.to_affine_host(mk.combine(port_rows(triples), C, 3))
    for b in range(3):
        stack = [jnp.asarray(REF_FQ.to_mont_np([t[i] for t in triples[b * W:(b + 1) * W]])
                             .T[:, :, None]) for i in range(3)]
        with jax.disable_jit():
            want = ref_ec.to_affine_host(ref_msm._combine_body(*stack, W, C))
        assert got[b] == want[0], b


def test_combine_rejects_ragged_batches():
    p = ec.infinity(6, "cpu")
    for batch in (0, 4, 7):
        with pytest.raises(ValueError):
            mk.combine(p, C, batch)
    assert all(a.shape == (3, NLIMBS) for a in mk.combine(p, C, 3))


@pytest.fixture(scope="module")
def small_ctx():
    """A device MSM context on the CPU over 64 dev-SRS bases (c = 4, 64
    windows), and its host points."""
    bases = dev_srs_g1(64, 42)
    return MSMContext(bases, device="cpu"), bases


def _vectors(rng):
    """Three Montgomery Fr vectors: uniform, 0/1 and a short one."""
    vals = [[int.from_bytes(rng.bytes(32), "little") % R for _ in range(64)],
            [int(v) for v in rng.integers(0, 2, 64)],
            [int.from_bytes(rng.bytes(32), "little") % R for _ in range(20)]]
    return vals, [to_tensor(FR.to_mont_np(v), "cpu") for v in vals]


def test_msm_vec_end_many_matches_single_ends(small_ctx):
    ctx, bases = small_ctx
    vals, vecs = _vectors(np.random.default_rng(31))
    handles = [ctx.msm_vec_begin(v) for v in vecs]
    before = dict(mk.launches)
    many = ctx.msm_vec_end_many(handles)
    assert many == [g1_msm_host(bases[:len(s)], s) for s in vals]
    assert many == [ctx.msm_vec_end(h) for h in handles]
    assert ctx.msm_vec_end_many([]) == []
    assert mk.launches == before


def test_commit_many_matches_commit_per_vector(small_ctx):
    ctx, bases = small_ctx
    vals, vecs = _vectors(np.random.default_rng(32))
    backend = TorchBackend("cpu")
    vs = [FrVec(v) for v in vecs]
    many = backend.commit_many(ctx, vs)
    assert many == [g1_msm_host(bases[:len(s)], s) for s in vals]
    assert many == [backend.commit(ctx, v) for v in vs]


def test_segments_of_a_warp_cover_one_index_range():
    """K6 stages the indices of 32 consecutive segments as one range of
    idx: for a 2^12 MSM with a planted skewed bucket, every run of 32
    consecutive segments covers one contiguous idx range (each non-empty
    segment starts where the one before it ends) of at most 32 * SEGMENT
    entries, and the empty segments trail the others.  So the segments of
    rows 32 w .. 32 w + 31 lie in the window of 32 * SEGMENT entries from
    seg_start[32 w], the one a warp stages."""
    n = 1 << 12
    zeros = torch.zeros((n, NLIMBS), dtype=torch.int32)
    ctx = MSMContext.from_device_affine(zeros, zeros, torch.zeros(n, dtype=torch.bool))
    rng = np.random.default_rng(12)
    scalars = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    scalars[:40 * SEGMENT] = [9] * (40 * SEGMENT)                  # 40 segments in one bucket
    scalars[2000:2100] = [0] * 100
    raw = to_tensor(FR.to_limbs_np(scalars), "cpu")
    idx, start, length, bucket = ctx._segments(ctx._sorted_keys(raw), n)
    used = int((length > 0).sum())
    assert int((bucket == 9).sum()) >= 40
    assert bool((length[:used] > 0).all()) and bool((length[used:] == 0).all())
    assert bool((start[1:used] == start[:used - 1] + length[:used - 1]).all())
    assert int(length[:used].sum()) == int((ctx._sorted_keys(raw) != (1 << 63) - 1).sum())
    for t0 in range(0, start.shape[0] - 31):
        s, l = start[t0:t0 + 32], length[t0:t0 + 32]
        live = l > 0
        if not bool(live.any()):
            continue
        lo, hi = int(s[live].min()), int((s + l)[live].max())
        assert hi - lo == int(l.sum()) <= 32 * SEGMENT, t0
        if t0 % 32 == 0:
            first = int(s[0])
            assert first <= lo and hi <= first + 32 * SEGMENT, t0
