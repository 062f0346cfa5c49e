"""The port's NTT layer (plonkit_tpu_torch/gpu/ntt.py on the K3 butterfly)
against the JAX package: `butterfly_dif` against the Pallas kernel in
interpret mode, the transforms against tpu/ntt.py and plonk/poly_host.py,
and the split coset transforms (used from 2^24 elements) at a lowered
threshold against the monolithic ones.  Exact comparisons throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonkit_tpu.fields import FR_GENERATOR, FR_MODULUS as R
from plonkit_tpu.plonk import poly_host
from plonkit_tpu.tpu import mont as ref_mont
from plonkit_tpu.tpu import ntt as ref_ntt
from plonkit_tpu.tpu import pallas_kernels as pk
from plonkit_tpu_torch import backend_torch, convert
from plonkit_tpu_torch.backend_torch import FrVec, TorchBackend
from plonkit_tpu_torch.gpu import mont, ntt


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def rand_elems(n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(max(n - 4, 0))]
    return (vals + [0, 1, R - 1, R - 2])[:n]


def port_vec(xs):
    return torch.from_numpy(convert.limbs16_to_rows(ref_mont.FR.to_mont_np(xs)).view(np.int32))


def ints(t):
    return mont.FR.from_mont_np(mont.to_numpy(t))


def same(port_t, ref_arr):
    return np.array_equal(convert.rows_to_limbs16(mont.to_numpy(port_t)), np.asarray(ref_arr))


def test_butterfly_dif_matches_pallas_interpret():
    xs, ys, ws = rand_elems(128, 1), rand_elems(128, 2)[::-1], rand_elems(128, 3)
    planar = [jnp.asarray(ref_mont.FR.to_mont_np(v)) for v in (xs, ys, ws)]
    u_ref, v_ref = pk.butterfly_dif(ref_mont.FR, *planar, interpret=True)
    u, v = ntt.butterfly_dif(port_vec(xs), port_vec(ys), port_vec(ws))
    assert same(u, u_ref) and same(v, v_ref)
    assert ints(u) == [(x + y) % R for x, y in zip(xs, ys)]
    assert ints(v) == [(x - y) * w % R for x, y, w in zip(xs, ys, ws)]


@pytest.mark.parametrize("n", [1, 2, 8, 256, 4096])
def test_ntt_intt_match_reference(n):
    xs = rand_elems(n, 10 + n)
    planar = jnp.asarray(ref_mont.FR.to_mont_np(xs))
    fwd, inv = ntt.ntt(port_vec(xs)), ntt.intt(port_vec(xs))
    assert same(fwd, ref_ntt.ntt(planar))
    assert same(inv, ref_ntt.intt(planar))
    if n <= 256:
        assert ints(fwd) == poly_host.ntt(list(xs))
        assert ints(inv) == poly_host.intt(list(xs))


@pytest.mark.parametrize("n", [8, 256])
def test_coset_transforms_match_reference(n):
    xs = rand_elems(n, 20 + n)
    planar = jnp.asarray(ref_mont.FR.to_mont_np(xs))
    v = port_vec(xs)
    assert same(ntt.coset_ntt(v), ref_ntt.coset_ntt(planar))
    assert same(ntt.coset_intt(v), ref_ntt.coset_intt(planar))
    assert same(ntt.coset_lde(v, 4), ref_ntt.coset_lde(planar, 4))
    assert same(ntt.coset_scale(v, 5), ref_ntt.coset_scale(planar, 5))
    assert ints(ntt.coset_ntt(v)) == poly_host.coset_ntt(list(xs))
    assert ints(ntt.coset_intt(v)) == poly_host.coset_intt(list(xs))
    assert ints(ntt.coset_lde(v, 4)) == poly_host.coset_ntt(list(xs) + [0] * (3 * n))


def test_powers_match_host():
    got = ints(ntt.powers(7, 37, "cpu"))
    assert got == [pow(7, i, R) for i in range(37)]


def test_split_coset_transforms_match_monolithic(monkeypatch):
    """TorchBackend's split coset LDE / iNTT (backend_jax.py:457-513) and
    its split coset NTT (four folded quarter transforms) at a threshold
    lowered from 2^24 to 4 * 256 elements."""
    n = 256
    xs = rand_elems(n, 30)
    b = TorchBackend(device="cpu")
    v = FrVec(port_vec(xs))
    lde_mono = b.coset_lde(v, 4)
    m_mono = b.coset_intt(lde_mono)
    wide = FrVec(port_vec(rand_elems(4 * n, 31)))
    c_mono = b.coset_ntt(wide)
    monkeypatch.setattr(backend_torch, "SPLIT_NTT_MIN", 4 * n)
    lde_split = b.coset_lde(v, 4)
    assert torch.equal(lde_mono.data, lde_split.data)
    m_split = b.coset_intt(lde_mono)
    assert torch.equal(m_mono.data, m_split.data)
    c_split = b.coset_ntt(wide)
    assert torch.equal(c_mono.data, c_split.data)
    assert torch.equal(b.coset_intt(c_split).data, wide.data)
    back = ints(m_split.data)
    assert back[:n] == xs and not any(back[n:])
    # and the split paths are what the JAX package computes there
    planar = jnp.asarray(ref_mont.FR.to_mont_np(xs))
    from plonkit_tpu.backend_jax import FrVec as RefVec, JaxBackend
    ref = JaxBackend()
    assert same(lde_split.data, ref._coset_lde_split(RefVec(planar), 4, FR_GENERATOR).data)
    wide_planar = jnp.asarray(ref_mont.FR.to_mont_np(rand_elems(4 * n, 31)))
    assert same(c_split.data, ref.coset_ntt(RefVec(wide_planar)).data)
