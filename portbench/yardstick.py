"""The yardstick: the card's peaks and the least work of a kernel launch,
counted from its inputs, whatever kernel does the work.  Copied from
chip_smoke.py's phase 3 (its bound arithmetic, `_least_glv_ops` and the MSM
counts) and curve.py's GLV split, so that a later change of the program
cannot move them.  Imports nothing of the program.

Peaks of one H100 SXM at its 700 W limit: HBM3 3.35e12 B/s and dense int8
1.979e15 operations/s are NVIDIA's data sheet; the 32-bit integer multiply
rate 16.75e12/s is derived, not published: 64 lanes an SM a clock on sm_90,
half the 128 FP32 lanes behind the data sheet's 67e12 float32 FLOP/s (two a
fused multiply-add), so 67e12 / 4.  A launch's least time is the larger of
its bytes over the bandwidth and its operations over their rate."""

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 67e12 / 4
INT8_OPS_PER_S = 1979e12

# 32-bit multiplies of a Montgomery product (64 + 64 wide products of two
# instructions, 8 for m = t0 n0) and of a squaring (36 distinct products)
MONT_MUL_OPS = 2 * (64 + 64) + 8
MONT_SQR_OPS = 2 * (36 + 64) + 8
POINT_BYTES = 3 * 32                   # a Jacobian point, [3, 8] words
MADD_MULS = 11                         # products of a mixed add, squarings counted whole
DBL_OPS = 2 * MONT_MUL_OPS + 5 * MONT_SQR_OPS      # dbl-2009-l: 2M + 5S
ADD_OPS = 12 * MONT_MUL_OPS + 4 * MONT_SQR_OPS     # add-2007-bl: 12M + 4S
# the GLV split of a scalar on the card: 100 wide 32 x 32 products
GLV_SPLIT_OPS = 2 * (8 * 3 + 8 * 5 + 2 * 2 + 4 * 4 + 2 * 4 + 4 * 2)
NAF_WIDTH = 5

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
GLV_A1, GLV_B1 = 0x89d3256894d213e3, -0x6f4d8248eeb859fc8211bbeb7d4f1128
GLV_A2, GLV_B2 = 0x6f4d8248eeb859fd0be4e1541221250b, 0x89d3256894d213e3
GLV_G1 = ((GLV_B2 << 256) + R // 2) // R
GLV_G2 = ((-GLV_B1 << 256) + R // 2) // R


def least_seconds(bytes_moved: float, int32_muls: float = 0, int8_ops: float = 0) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, int32_muls / INT32_MUL_PER_S,
               int8_ops / INT8_OPS_PER_S)


def k6_least_seconds(entries: int, segments: int, rows: int) -> float:
    """K6 bucket_sweep: `entries` bases summed into `segments` non-empty
    segments of a table of `rows` segment rows: each entry reads its index
    and its 64-byte affine base, each row its start and length and writes
    its point; a mixed add for each entry past the first of its segment."""
    return least_seconds(entries * (64 + 4) + rows * (16 + POINT_BYTES),
                         (entries - segments) * MADD_MULS * MONT_MUL_OPS)


def k10_least_seconds(m: int, n: int, kp: int) -> float:
    """K10 dft_product: int32 G [M, N] = A [M, Kp] . X [N, Kp]^T in int8,
    where the depth that carries digits is M (the radix times 33 digits)
    and Kp pads it to a multiple of 32."""
    return least_seconds(m * kp + n * kp + 4 * m * n, int8_ops=2 * m * n * m)


def glv_split(k: int) -> tuple:
    """k1 + k2 lambda = k (mod r) with |k1|, |k2| < 2^127, by Babai rounding
    on BN254's short basis (curve.py's glv_split)."""
    c1 = (k * GLV_G1 + (1 << 255)) >> 256
    c2 = (k * GLV_G2 + (1 << 255)) >> 256
    return k - c1 * GLV_A1 - c2 * GLV_A2, -c1 * GLV_B1 - c2 * GLV_B2


def naf_digits(mags: list, device="cpu") -> tuple:
    """The width-5 NAF of each magnitude below 2^128, all at once: its
    count of non-zero digits and its top digit's position (-1 for 0)."""
    import torch
    n = len(mags)
    raw = np.frombuffer(b"".join(m.to_bytes(17, "little") for m in mags), np.uint8)
    bits = np.unpackbits(raw.reshape(n, 17).T, axis=0, bitorder="little")
    bits = torch.from_numpy(np.concatenate([bits, np.zeros((NAF_WIDTH, n), np.uint8)]))
    bits = bits.to(device)
    carry = torch.zeros(n, dtype=torch.uint8, device=device)
    skip = torch.zeros(n, dtype=torch.uint8, device=device)
    count = torch.zeros(n, dtype=torch.int64, device=device)
    top = torch.full((n,), -1, dtype=torch.int64, device=device)
    for i in range(17 * 8):
        win = carry + sum(bits[i + j] << j for j in range(NAF_WIDTH))
        free = skip == 0
        odd = free & (win & 1 == 1)
        count += odd
        top[odd] = i
        carry = torch.where(odd, win >> (NAF_WIDTH - 1),
                            torch.where(free, (bits[i] + carry) >> 1, carry))
        skip = torch.where(odd, NAF_WIDTH - 1, torch.where(free, 0, skip - 1)).to(torch.uint8)
    return count.cpu().numpy(), top.cpu().numpy()


def least_glv_ops(scalars: list, split: bool, device="cpu") -> np.ndarray:
    """32-bit multiplies of the least work known for [k] P for each scalar
    (0 <= k < r; none for k = 1): the odd multiples P .. 15P (a doubling and
    7 adds) and phi's x of the 8, then each half's width-5 NAF over them (a
    doubling a position below the higher top digit, an add a non-zero digit
    but the first), and with `split` the split itself."""
    real = [k for k in scalars if k != 1]
    halves = [glv_split(k) for k in real]
    count, top = naf_digits([abs(h[0]) for h in halves] + [abs(h[1]) for h in halves], device)
    (c1, c2), (t1, t2) = np.split(count, 2), np.split(top, 2)
    ops = (DBL_OPS + 7 * ADD_OPS + 8 * MONT_MUL_OPS + GLV_SPLIT_OPS * split
           + np.maximum(np.maximum(t1, t2), 0) * DBL_OPS
           + np.maximum(c1 + c2 - 1, 0) * ADD_OPS)
    out = np.zeros(len(scalars), np.int64)
    out[[k != 1 for k in scalars]] = ops
    return out


def k14_least_seconds(lanes: int, glv_ops: int) -> float:
    """K14 g1_butterfly over lanes (lo, hi, w): lo +- [w] hi, each lane
    reading two Jacobian points and its twiddle and writing two points;
    glv_ops is least_glv_ops(twiddles, True) summed over the lanes."""
    return least_seconds(lanes * (4 * POINT_BYTES + 32), glv_ops + 2 * ADD_OPS * lanes)


def k15_least_seconds(points: int, scalar: int, device="cpu") -> float:
    """K15 g1_scale: [s] P for `points` points and one scalar s."""
    ops = int(least_glv_ops([scalar % R], False, device)[0]) * points
    return least_seconds(points * 2 * POINT_BYTES + 32, ops)
