"""The yardstick's copied counts give the bounds of chip_smoke.py's phase 3
(PERF.md's kernel table, PR 19) at the same shapes and inputs."""

import numpy as np
import pytest

from portbench import yardstick as y
from portbench.reference import bn254


def test_k14_k15_bounds_of_a_2p20_inverse_transform():
    n = 1 << 20
    w_inv = bn254.inv(bn254.omega(n), bn254.R)
    tw = [1] * (n // 2)
    for i in range(1, n // 2):
        tw[i] = tw[i - 1] * w_inv % bn254.R
    ops = int(y.least_glv_ops(tw, True).sum())
    assert y.k14_least_seconds(len(tw), ops) * 1e3 == pytest.approx(12.5841, abs=5e-5)
    assert y.k15_least_seconds(n, bn254.inv(n, bn254.R)) * 1e3 == pytest.approx(24.4216, abs=5e-5)


def test_k6_bound_of_the_smoke_input():
    """chip_smoke.py's K6 row: 2^20 scalars of its seeded generator, c = 12
    over 22 windows, segments of at most 32 entries."""
    def limbs(v):
        return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    n, c, windows = 1 << 20, 12, 22
    rng = np.random.default_rng(20240917 + 1)
    rows = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    rows[:, 7] %= np.uint32(limbs(bn254.R)[7])
    rows[0:4] = np.array([limbs(v) for v in (0, 1, bn254.R - 1, bn254.R - 2)], np.uint32)
    rows[4:4 + 7 * 32] = np.array(limbs(7), np.uint32)
    wide = rows.astype(np.int64)
    entries = segments = 0
    for w in range(windows):
        bit = w * c
        v = wide[:, bit >> 5] >> (bit & 31)
        if (bit & 31) + c > 32 and (bit >> 5) + 1 < 8:
            v |= wide[:, (bit >> 5) + 1] << (32 - (bit & 31))
        count = np.bincount(v & ((1 << c) - 1), minlength=1 << c)[1:]
        entries += int(count.sum())
        segments += int(((count + 31) // 32).sum())
    rows_table = min(windows * n, -(-windows * n // 32) + (windows << c))
    assert y.k6_least_seconds(entries, segments, rows_table) * 1e3 == \
        pytest.approx(3.80114, abs=5e-6)


def test_k10_bound_of_the_radix_128_level():
    """The K10 row: radix 128 at 2^20 points, A [128 * 33, 4224], 8192 columns."""
    m, kp = 128 * 33, 4224
    assert y.k10_least_seconds(m, 8192, kp) * 1e3 == pytest.approx(0.147714, abs=5e-7)


def test_glv_split_recombines():
    lam = 0xb3c4d79d41a917585bfc41088d8daaa78b17ea66b99c90dd
    for k in (0, 1, 2, bn254.R - 1, 12345678901234567890 ** 3 % bn254.R):
        k1, k2 = y.glv_split(k)
        assert (k1 + k2 * lam) % bn254.R == k and max(abs(k1), abs(k2)) < 1 << 127
