"""The port's group NTT (plonkit_tpu_torch/gpu/group_ntt.py) on the CPU,
through the plain versions of K14 g1_butterfly and K15 g1_scale, exact
bytes everywhere:

- the plain K14 and K15 against the JAX package's host curve arithmetic
  (g1_mul, g1_add, g1_neg), lane by lane after the affine conversion, on
  seeded Jacobian lanes with the planted cases of chip_smoke.py's phase 3
  (lo, hi or both at infinity, lo = [w]hi, lo = -[w]hi, w = 1);
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

import numpy as np
import pytest
import torch

from plonkit_tpu import api as ref_api
from plonkit_tpu.curve import G1_GEN, g1_add, g1_mul, g1_neg
from plonkit_tpu.serialization import Crs as RefCrs
from plonkit_tpu_torch import api, cli, native
from plonkit_tpu_torch.backend import HostMSMContext
from plonkit_tpu_torch.fields import FR_MODULUS as R, fr_inv, get_domain_omega
from plonkit_tpu_torch.gpu import ec, group_ntt
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


def test_plain_butterfly_equals_host_curve():
    rng = np.random.default_rng(SEED + 1)
    n = 12
    bases = [g1_mul(G1_GEN, int.from_bytes(rng.bytes(32), "little") % R) for _ in range(2 * n)]
    w = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
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


@pytest.mark.parametrize("s", [0, 1, 2, 15, 16, 17, fr_inv(1 << 20), R - 1, 1 << 255])
def test_plain_scale_equals_host_curve(s):
    rng = np.random.default_rng(SEED + 2)
    pts = [g1_mul(G1_GEN, int.from_bytes(rng.bytes(32), "little") % R) for _ in range(5)]
    pts[2] = None
    got = affine(group_ntt.g1_scale(jacobian(pts), s))
    assert got == [g1_mul(p, s % R) if p is not None else None for p in pts]


def test_ladder_digits_and_table():
    """window_digits reads the canonical limbs' 4-bit windows least
    significant first."""
    d = group_ntt.window_digits(scalar_rows([0x1234, R - 1]))
    assert d[0, :4].tolist() == [4, 3, 2, 1] and not d[0, 4:].any()
    v = sum(int(x) << (4 * i) for i, x in enumerate(d[1].tolist()))
    assert v == R - 1


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
