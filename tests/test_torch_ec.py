"""The port's plain G1 Jacobian arithmetic (plonkit_tpu_torch/gpu/ec.py)
against the JAX package's tpu/ec.py, limb for limb, through convert.py.

The reference functions are called eagerly (no jax.jit, whose compile of
one EC graph costs tens of seconds on the CPU), on 256 seeded points: P and
Q random with random Z, and planted lanes for P + P (same point, other Z),
P + (-P), infinity on either side, both infinities, and an infinity that
carries non-zero X and Y (what the unchecked forms leave after P + (-P)).
The non-degenerate lanes are also held against tpu/ec_flat.py, the
formulas inside the Pallas bodies of the sweep (K6) and padd (K7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonkit_tpu.tpu import ec as ref_ec
from plonkit_tpu.tpu import ec_flat as ref_flat
from plonkit_tpu.tpu.mont import FQ as REF_FQ
from plonkit_tpu_torch import convert
from plonkit_tpu_torch.curve import G1_GEN, g1_add, g1_mul, g1_neg
from plonkit_tpu_torch.fields import FQ_MODULUS as Q
from plonkit_tpu_torch.gpu import ec

N = 256
# planted lanes: name -> (first lane, count)
PLANTS = {"same": (200, 10), "neg": (210, 10), "p_inf": (220, 10), "q_inf": (230, 10),
          "both_inf": (240, 8), "junk_inf": (248, 8)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def host_points(n, rng):
    """n distinct affine points a*G + i*b*G (cheap: one add each)."""
    a, b = (int(rng.integers(1, 1 << 62)) for _ in range(2))
    p, step = g1_mul(G1_GEN, a), g1_mul(G1_GEN, b)
    out = []
    for _ in range(n):
        out.append(p)
        p = g1_add(p, step)
    return out


def to_jacobian(points, zs):
    """Affine host points -> Jacobian (X, Y, Z) ints with the given Z
    (None = infinity, all zeros)."""
    out = []
    for p, z in zip(points, zs):
        if p is None:
            out.append((0, 0, 0))
        else:
            z2 = z * z % Q
            out.append((p[0] * z2 % Q, p[1] * z2 * z % Q, z))
    return out


def planar(triples):
    """Jacobian int triples -> the JAX package's three [16, N] Montgomery
    arrays."""
    return tuple(REF_FQ.to_mont_np([t[i] for t in triples]) for i in range(3))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(2024)
    pts = host_points(2 * N, rng)
    p_aff, q_aff = pts[:N], pts[N:]
    lo, n = PLANTS["same"]
    q_aff[lo:lo + n] = p_aff[lo:lo + n]
    lo, n = PLANTS["neg"]
    q_aff[lo:lo + n] = [g1_neg(p) for p in p_aff[lo:lo + n]]
    lo, n = PLANTS["p_inf"]
    p_aff[lo:lo + n] = [None] * n
    lo, n = PLANTS["q_inf"]
    q_aff[lo:lo + n] = [None] * n
    for name in ("both_inf", "junk_inf"):
        lo, n = PLANTS[name]
        p_aff[lo:lo + n] = [None] * n
        q_aff[lo:lo + n] = [None] * n
    zp = [int(rng.integers(1, 1 << 62)) for _ in range(N)]
    zq = [int(rng.integers(1, 1 << 62)) for _ in range(N)]
    p_jac = to_jacobian(p_aff, zp)
    q_jac = to_jacobian(q_aff, zq)
    # infinities with non-zero X, Y: Z = 0 decides
    lo, n = PLANTS["junk_inf"]
    for i in range(lo, lo + n):
        p_jac[i] = (i + 1, 2 * i + 3, 0)
        q_jac[i] = (3 * i + 5, 7, 0) if i % 2 else (0, 0, 0)
    return p_aff, q_aff, planar(p_jac), planar(q_jac)


def port(planar_triple):
    return convert.jacobian_to_port(planar_triple, "cpu")


def assert_same(port_triple, ref_triple):
    got = convert.jacobian_from_port(port_triple)
    for g, w in zip(got, ref_triple):
        assert np.array_equal(g, np.asarray(w))


def ref_affine(q_aff):
    x, y, inf = ref_ec.affine_from_host(q_aff)
    return x, y, inf


def test_double_matches_reference(inputs):
    _, _, p, _ = inputs
    assert_same(ec.double(port(p)), ref_ec.double(tuple(map(jnp.asarray, p))))


def test_add_matches_reference(inputs):
    _, _, p, q = inputs
    want = ref_ec.add(tuple(map(jnp.asarray, p)), tuple(map(jnp.asarray, q)))
    got = ec.add(port(p), port(q))
    assert_same(got, want)
    # P + (-P) gives all zeros, P + P the doubled point
    lo, n = PLANTS["neg"]
    assert all(bool((a[lo:lo + n] == 0).all()) for a in got)
    lo, n = PLANTS["same"]
    dbl = ec.double(port(p))
    assert ec.to_affine_host(tuple(a[lo:lo + n] for a in got)) == \
        ec.to_affine_host(tuple(a[lo:lo + n] for a in dbl))


def test_add_mixed_matches_reference(inputs):
    _, q_aff, p, _ = inputs
    aff = ref_affine(q_aff)
    want = ref_ec.add_mixed(tuple(map(jnp.asarray, p)), aff)
    got = ec.add_mixed(port(p), convert.affine_to_port(aff, "cpu"))
    assert_same(got, want)


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "jacobian"])
def test_unchecked_adds_match_reference(inputs, mixed):
    _, q_aff, p, q = inputs
    pj = tuple(map(jnp.asarray, p))
    if mixed:
        aff = ref_affine(q_aff)
        (want, bad_w) = ref_ec.add_mixed_unchecked(pj, aff)
        got, bad_g = ec.add_mixed_unchecked(port(p), convert.affine_to_port(aff, "cpu"))
    else:
        (want, bad_w) = ref_ec.add_unchecked(pj, tuple(map(jnp.asarray, q)))
        got, bad_g = ec.add_unchecked(port(p), port(q))
    assert_same(got, want)
    assert np.array_equal(bad_g.numpy(), np.asarray(bad_w))
    lo, n = PLANTS["same"]
    assert bool(bad_g[lo:lo + n].all()) and int(bad_g.sum()) == n


def _flat(a, n):
    """[16, n] planar limbs -> ec_flat's list of 16 [1, n] arrays."""
    return [jnp.asarray(a[i][None, :n]) for i in range(16)]


def test_flat_formulas_match_on_generic_lanes(inputs):
    """ec_flat (the Pallas bodies' formulas) on the 200 lanes with distinct
    finite operands equals the port's unchecked and complete adds."""
    _, q_aff, p, q = inputs
    n = PLANTS["same"][0]
    fp = tuple(_flat(a, n) for a in p)
    (fx, fy, fz), fbad = ref_flat.add_unchecked(fp, tuple(_flat(a, n) for a in q))
    got, _ = ec.add_unchecked(*(tuple(a[:n] for a in port(t)) for t in (p, q)))
    assert_same(got, tuple(np.concatenate([np.asarray(l) for l in c]) for c in (fx, fy, fz)))
    assert not bool(np.asarray(fbad).any())
    x, y, inf = ref_affine(q_aff[:n])
    (mx, my, mz), mbad = ref_flat.add_mixed_unchecked(
        fp, _flat(np.asarray(x), n), _flat(np.asarray(y), n), jnp.asarray(np.asarray(inf))[None])
    pn = tuple(a[:n] for a in port(p))
    got = ec.add_mixed(pn, convert.affine_to_port((x, y, inf), "cpu"))
    assert_same(got, tuple(np.concatenate([np.asarray(l) for l in c]) for c in (mx, my, mz)))
    assert not bool(np.asarray(mbad).any())


def test_neg_and_host_conversions(inputs):
    p_aff, _, p, _ = inputs
    pj = port(p)
    assert_same(ec.neg(pj), ref_ec.neg(tuple(map(jnp.asarray, p))))
    lo = PLANTS["junk_inf"][0]
    assert ec.to_affine_host(pj)[:lo] == p_aff[:lo]
    assert ec.to_affine_host(pj) == ref_ec.to_affine_host(tuple(map(jnp.asarray, p)))
    aff = ec.affine_from_host(p_aff[:64], "cpu")
    ref = ref_ec.affine_from_host(p_aff[:64])
    for g, w in zip(convert.affine_from_port(aff), ref):
        assert np.array_equal(g, np.asarray(w))
    assert_same(ec.jacobian_from_affine(aff), ref_ec.jacobian_from_affine(ref))
    assert ec.to_affine_host(ec.jacobian_from_affine(aff)) == p_aff[:64]
    assert bool(ec.is_infinity(ec.infinity(3, "cpu")).all())
