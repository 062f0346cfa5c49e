"""The port's fixed-base ladder and device SRS (plonkit_tpu_torch/gpu/
fixed_base.py) on the CPU, through the plain versions of K7 and K1: the
tau = 42 SRS at 2^8 equals srs.py's points and the first 2^8 points of the
in-repo key, and its key file (serialization.save_crs_g1_limbs) equals the
one Crs.save writes; batch_scalar_mul_base on seeded scalars, 0, 1 and
r - 1 included, equals the JAX package's curve.g1_mul; to_affine_batch
maps infinity to infinity; chip_smoke.py's digest of the 2^22-point
prefix of its key is that of the in-repo key's points."""

import hashlib
import os
import runpy

import numpy as np
import pytest
import torch

from plonkit_tpu.curve import G1_GEN as REF_G1_GEN, g1_mul as ref_g1_mul
from plonkit_tpu_torch.api import DEV_TAU
from plonkit_tpu_torch.curve import G2_GEN, g2_mul
from plonkit_tpu_torch.fields import FR_MODULUS as R
from plonkit_tpu_torch.gpu import ec, fixed_base, msm_kernels as mk
from plonkit_tpu_torch.gpu.mont import FQ
from plonkit_tpu_torch.serialization import Crs, load_crs_g1_limbs, save_crs_g1_limbs
from plonkit_tpu_torch.srs import dev_srs_g1

from test_torch_prove import KEY

LOG2 = 8
SEED = 20241017


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def points(x, y, inf):
    return [None if i else (a, b)
            for a, b, i in zip(FQ.from_limbs_np(x), FQ.from_limbs_np(y), inf)]


@pytest.fixture(scope="module")
def srs_rows():
    before = mk.launches["padd"]
    rows = fixed_base.gen_crs_g1_device(LOG2, DEV_TAU, device="cpu")
    assert mk.launches["padd"] == before           # plain versions: no launch
    return rows


def test_device_srs_equals_serial_srs_and_key(srs_rows):
    got = points(*srs_rows)
    assert got == dev_srs_g1(1 << LOG2, DEV_TAU)
    assert got == points(*load_crs_g1_limbs(KEY, 1 << LOG2))


def test_device_srs_key_file_equals_crs_save(srs_rows, tmp_path):
    g2 = [G2_GEN, g2_mul(G2_GEN, DEV_TAU)]
    save_crs_g1_limbs(str(tmp_path / "limbs.key"), *srs_rows, g2)
    Crs(dev_srs_g1(1 << LOG2, DEV_TAU), g2).save(str(tmp_path / "crs.key"))
    assert (tmp_path / "limbs.key").read_bytes() == (tmp_path / "crs.key").read_bytes()


def test_device_srs_chunks_join(monkeypatch, srs_rows):
    """Several chunks (tau powers carried from one to the next) give the
    same points as one."""
    monkeypatch.setattr(fixed_base, "CRS_CHUNK_LOG2", LOG2 - 2)
    for a, b in zip(fixed_base.gen_crs_g1_device(LOG2, DEV_TAU, device="cpu"), srs_rows):
        assert np.array_equal(a, b)


def test_batch_scalar_mul_base_equals_reference():
    rng = np.random.default_rng(SEED)
    scalars = [0, 1, R - 1, R, 2, 255, 256, 1 << 253] + \
        [int.from_bytes(rng.bytes(32), "little") % R for _ in range(24)]
    jac = fixed_base.batch_scalar_mul_base(scalars, device="cpu")
    got = points(*fixed_base.affine_batch_to_limbs(fixed_base.to_affine_batch(jac)))
    assert got == [ref_g1_mul(REF_G1_GEN, s % R) for s in scalars]
    assert got[0] is None and got[3] is None


def test_to_affine_batch_maps_infinity_to_infinity():
    jac = fixed_base.batch_scalar_mul_base([5, 0, 7], device="cpu")
    inf = ec.infinity(3, "cpu")
    mixed = tuple(torch.stack([j[0], i[1], j[2]]) for j, i in zip(jac, inf))
    x, y, flags = fixed_base.to_affine_batch(mixed)
    assert flags.tolist() == [False, True, False]
    assert not bool(x[1].any()) and not bool(y[1].any())
    assert points(*fixed_base.affine_batch_to_limbs((x, y, flags))) == \
        [ref_g1_mul(REF_G1_GEN, 5), None, ref_g1_mul(REF_G1_GEN, 7)]


def test_smoke_srs_prefix_digest_is_the_keys():
    """chip_smoke.py holds the first 2^22 points of the 2^23 key it makes on
    the card against SRS_PREFIX_SHA256: the digest of the points of the
    in-repo 2^22 tau = 42 key, its header left out."""
    smoke = runpy.run_path(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
    with open(KEY, "rb") as f:
        count = int.from_bytes(f.read(8), "big")
        digest = hashlib.sha256(f.read(64 * count)).hexdigest()
    assert count == 1 << smoke["SRS_PREFIX_LOG2"]
    assert digest == smoke["SRS_PREFIX_SHA256"]
