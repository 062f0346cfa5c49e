"""The G1 group NTT: wrappers of K14 g1_butterfly, K15 g1_scale and K16
g1_points_in (csrc/group_ntt.cu), each beside its plain PyTorch version,
and group_intt, the inverse transform over SRS points that
api.crs_lagrange_form runs to make the Lagrange form of a key.

No TPU kernel stands behind them: the JAX package's group NTT is host
python (plonkit_tpu/api.py:99 _group_ntt, one g1_mul a butterfly), which
would take days at a 2^20 domain.  Here the transform stays on the device
from the key's limb rows to the Lagrange key's; no python int per point is
made.

Both kernels multiply by a scalar k on BN254's endomorphism (GLV,
curve.glv_split): [k]P = [k1]P + [k2]phi(P) with phi(x, y) = (beta x, y)
and |k1|, |k2| < 2^128, each half in 32 windows of one odd signed digit in
+-{1, 3, ..., 15} (glv_recode), over a table of P, 3P, ..., 15P.  The plain
versions below run the kernels' point operations in the kernels' order
(scalar_mul_plain), so every output limb is theirs.

Points are Jacobian triples of [N, 8] int32 Montgomery Fq rows (gpu/ec.py);
scalars are [N, 8] int32 rows of canonical little-endian Fr limbs.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel on the
current stream or raises.  `launches` counts kernel launches, one per call
that launched.

A launch runs each lane on lane_group(lanes, SMs) sub-groups of
product_split(lanes, SMs) threads of a warp: the sub-groups share out the
ladder's products, and the threads of a sub-group split each product
between them.  Profiling's `g1_lane_groups` counts the launches whose lane
has more than one sub-group, `g1_split_products` those whose products are
split.
"""

import functools

import numpy as np
import torch

from ..curve import GLV_BETA, glv_split
from ..fields import FR_MODULUS, fr_inv, get_domain_omega
from ..profiling import count, register_launches, span
from . import build, ec, field_kernels as fk, mont, ntt as gntt
from .field_kernels import check_operands, stream_ptr
from .fixed_base import affine_batch_to_limbs, to_affine_batch
from .mont import FQ, FR, NLIMBS, to_numpy

launches = {"g1_butterfly": 0, "g1_scale": 0, "g1_points_in": 0}
register_launches(launches)
count("g1_lane_groups", 0)
count("g1_split_products", 0)

GLV_WINDOWS = 32        # 4-bit windows of a half, |k_i| < 2^128 (csrc/group_ntt.cu)
TABLE = 8               # the odd multiples P, 3P, ..., 15P
LANE_GROUPS = (1, 2, 4)     # sub-groups a lane the kernels take (threads, unsplit)
PRODUCT_SPLITS = (1, 2)     # threads a sub-group the kernels take (2 with 4 sub-groups)
SCHEDULERS_PER_SM = 4       # warp schedulers of an SM (the H100's, and every card's since Volta)


def lane_group(lanes: int, sms: int) -> int:
    """Threads of one warp that K14 or K15 gives each of a launch's `lanes`
    lanes on a card of `sms` SMs: 1 when a thread a lane already gives
    every warp scheduler of the card a warp, else the smallest group that
    does, at most 4 (a point formula's widest level of products).  On the
    H100 this is the fastest group at every lane count timed (PERF.md, the
    crossover)."""
    for g in LANE_GROUPS:
        if lanes * g >= 32 * SCHEDULERS_PER_SM * sms:
            return g
    return LANE_GROUPS[-1]


def product_split(lanes: int, sms: int) -> int:
    """Threads of one warp that K14 or K15 splits each Montgomery product
    of a lane's ladder over, on a card of `sms` SMs: 2 where lane_group's 4
    threads a lane, doubled, still give each warp scheduler of the card at
    most one warp (up to 2,112 lanes on the H100: the 2^12 key's 2^11-lane
    stages), else 1.  There a stage lasts one lane's chain of products and
    the split shortens it; with two warps a scheduler the split's added
    instructions cost more than it saves (2^12 lanes: 0.448 ms at g = 4,
    0.578 split; PERF.md, the crossover)."""
    fits = lanes * LANE_GROUPS[-1] * PRODUCT_SPLITS[-1] <= 32 * SCHEDULERS_PER_SM * sms
    return PRODUCT_SPLITS[-1] if fits else PRODUCT_SPLITS[0]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _group_of(lanes: int, device: torch.device) -> tuple:
    """(sub-groups, threads a sub-group) of a launch of `lanes` lanes."""
    sms = _sm_count(device)
    g, s = lane_group(lanes, sms), product_split(lanes, sms)
    if g > 1:
        count("g1_lane_groups")
    if s > 1:
        count("g1_split_products")
    return g, s


def glv_recode(k: int) -> tuple:
    """The ladder's form of a scalar 0 <= k < r: ((E1, E2), (even1, even2))
    for the halves k1, k2 of curve.glv_split, E_i = floor(k_i / 2) + 2^127
    and even_i = k_i is even.  With e_j the j-th nibble of E_i, sum_j (2 e_j
    - 15) 16^j = 2 E_i - (2^128 - 1) = k_i + even_i: 32 odd signed digits a
    half, the odd value k_i + even_i, whose extra P (or phi(P)) the ladder
    takes off at the end.  |k_i| < 2^128 keeps E_i in [0, 2^128)."""
    halves = glv_split(k)
    es = tuple((h >> 1) + (1 << 127) for h in halves)
    if not all(0 <= e < 1 << 128 for e in es):
        raise ValueError(f"{k}: a half of its split does not fit 128 bits")
    return es, tuple(h & 1 == 0 for h in halves)


def glv_scalars(ks, device) -> tuple:
    """Python ints 0 <= k < r -> their nibbles [N, 2, 32] int64 (E1, E2,
    least significant first) and even flags [N, 2] bool, on `device`."""
    recoded = [glv_recode(k) for k in ks]
    shifts = np.arange(0, 4 * GLV_WINDOWS, 4, dtype=np.uint64)
    words = np.array([[(e >> s) & 0xFFFFFFFF for e in es for s in range(0, 128, 32)]
                      for es, _ in recoded], dtype=np.uint64).reshape(-1, 2, 4)
    nib = (words[:, :, shifts // 32] >> (shifts % 32)) & 15
    even = np.array([ev for _, ev in recoded], dtype=bool).reshape(-1, 2)
    return (torch.from_numpy(nib.astype(np.int64)).to(device),
            torch.from_numpy(even).to(device))


def scalar_mul_plain(p, nib: torch.Tensor, even: torch.Tensor):
    """[k_i] p_i for every lane, by csrc/group_ntt.cu's ladder over all
    lanes at once, from the lanes' glv_scalars: the table T[i] = (2i + 1)p
    (one doubling D = 2p, then T[i] = T[i - 1] + D), and phi of its x; acc
    = entry(E1's top nibble) + phi-entry(E2's), then for each lower window
    four doublings and the complete adds of the two entries; last, -p if k1
    is even and -phi(p) if k2 is.  An entry of nibble e is T[e - 8] for e >=
    8, else -T[7 - e].  Every lane runs the same operations, as every
    thread of the kernel does."""
    n = nib.shape[0]
    if n == 0:
        return ec.infinity(0, nib.device)
    d = ec.double(p)
    table = [p]
    for _ in range(1, TABLE):
        table.append(ec.add(table[-1], d))
    x, y, z = (torch.stack([t[c] for t in table]) for c in range(3))     # [8, N, 8]
    phi_x = mont.mont_mul(FQ, x.reshape(-1, 8), FQ.const(GLV_BETA, TABLE * n, x.device))
    phi_x = phi_x.reshape(TABLE, n, 8)
    lanes = torch.arange(n, device=nib.device)

    def entry(half: int, j: int):
        e = nib[:, half, j]
        i = torch.where(e >= 8, e - 8, 7 - e)
        ey = y[i, lanes]
        return ((phi_x if half else x)[i, lanes], torch.where((e < 8)[:, None],
                                                              mont.neg(FQ, ey), ey), z[i, lanes])

    top = GLV_WINDOWS - 1
    acc = ec.add(entry(0, top), entry(1, top))
    for j in range(top - 1, -1, -1):
        for _ in range(4):
            acc = ec.double(acc)
        acc = ec.add(acc, entry(0, j))
        acc = ec.add(acc, entry(1, j))
    inf = ec.infinity(n, nib.device)
    acc = ec.add(acc, ec.select(even[:, 0], ec.neg(p), inf))
    return ec.add(acc, ec.select(even[:, 1], ec.neg((phi_x[0], p[1], p[2])), inf))


# -- K14 ---------------------------------------------------------------------

def _butterfly_operands(lo, hi, w, out) -> tuple:
    """(lanes, row stride, out) of a K14 call: w [N, 8] contiguous; lo and
    hi Jacobian triples of [N, 8] int32 rows with dense limbs, all six one
    whole number of rows apart (1 for contiguous rows; 2 for a stage's
    even and odd rows, c[0::2] and c[1::2] of one buffer c); out a triple
    of contiguous [2N, 8] buffers that share no memory with lo and hi (a
    fresh one where it is not given): the lo outputs go to its rows [0,
    N), the hi outputs to rows [N, 2N)."""
    check_operands(w)
    n = w.shape[0]
    rows = (*lo, *hi)
    for t in rows:
        if (t.dtype != torch.int32 or t.shape != w.shape or t.device != w.device
                or t.stride() != rows[0].stride() or t.stride(1) != 1
                or t.stride(0) % NLIMBS or t.stride(0) < NLIMBS):
            raise ValueError(f"K14 takes lo and hi as [{n}, {NLIMBS}] int32 rows on {w.device},"
                             " one whole number of rows apart")
        if t.is_cuda and t.data_ptr() % 16:
            raise ValueError("operand rows must be 16-byte aligned")
    if out is None:
        out = tuple(torch.empty((2 * n, NLIMBS), dtype=torch.int32, device=w.device)
                    for _ in range(3))
    check_operands(*out)
    if out[0].shape[0] != 2 * n or out[0].device != w.device:
        raise ValueError(f"K14 writes a triple of [{2 * n}, {NLIMBS}] buffers on {w.device}")
    held = {t.untyped_storage().data_ptr() for t in rows}
    if any(o.untyped_storage().data_ptr() in held for o in out):
        raise ValueError("K14's out shares memory with its lo and hi")
    return n, rows[0].stride(0) // NLIMBS, out


def g1_butterfly_plain(lo, hi, w, out=None):
    """K14's plain version, in K14's operands and outputs
    (_butterfly_operands)."""
    n, _, out = _butterfly_operands(lo, hi, w, out)
    ks = FR.from_limbs_np(to_numpy(w))
    if any(k >= FR_MODULUS for k in ks):
        raise ValueError("a twiddle is not canonical: K14 takes w < r")
    one = torch.tensor([k == 1 for k in ks], dtype=torch.bool, device=w.device)
    t = hi
    if not bool(one.all()):
        t = ec.select(one, hi, scalar_mul_plain(hi, *glv_scalars(ks, w.device)))
    for o, a, b in zip(out, ec.add(lo, t), ec.add(lo, ec.neg(t))):
        o[:n], o[n:] = a, b
    return tuple(o[:n] for o in out), tuple(o[n:] for o in out)


def g1_butterfly(lo, hi, w, out=None):
    """K14, one radix-2 DIT stage over G1: (lo + [w]hi, lo - [w]hi) lane
    by lane; lo and hi Jacobian triples, w [N, 8] canonical Fr rows.  A
    stage of a transform passes the even and odd rows of one buffer as lo
    and hi and another buffer as `out`, which takes the two halves: one
    launch, no copy (_butterfly_operands).  Returns the two halves of out
    as triples.  Each w must be below r: the card splits it unchecked (for
    w >= r its products overflow their limbs and the point is wrong); the
    plain version raises ValueError."""
    if not w.is_cuda:
        return g1_butterfly_plain(lo, hi, w, out)
    n, stride, out = _butterfly_operands(lo, hi, w, out)
    if n:
        lib = build.load("group_ntt")
        halves = (*(o[:n] for o in out), *(o[n:] for o in out))
        build.check(lib.plonkit_g1_butterfly(*(t.data_ptr() for t in (*lo, *hi, w, *halves)), n,
                                             stride, *_group_of(n, w.device), stream_ptr(w)),
                    "K14 g1_butterfly")
        launches["g1_butterfly"] += 1
    return tuple(o[:n] for o in out), tuple(o[n:] for o in out)


# -- K15 ---------------------------------------------------------------------

def g1_scale_plain(p, s: int):
    k = s % FR_MODULUS
    if k == 1:
        return p
    n = p[0].shape[0]
    nib, even = glv_scalars([k], p[0].device)
    return scalar_mul_plain(p, nib.expand(n, 2, GLV_WINDOWS), even.expand(n, 2))


def scale_args(s: int) -> np.ndarray:
    """K15's scalar as its kernel argument, recoded once: [E1 (4 words), E2
    (4 words), even1, even2, s = 1 mod r] uint32."""
    k = s % FR_MODULUS
    (e1, e2), (even1, even2) = glv_recode(k)
    words = [(e >> sh) & 0xFFFFFFFF for e in (e1, e2) for sh in range(0, 128, 32)]
    return np.array(words + [even1, even2, k == 1], dtype=np.uint32)


def g1_scale(p, s: int):
    """K15: [s] p lane by lane, for one scalar s >= 0 (taken mod r)."""
    check_operands(*p)
    if s < 0:
        raise ValueError(f"scalar {s} is negative")
    if not p[0].is_cuda:
        return g1_scale_plain(p, s)
    n = p[0].shape[0]
    out = tuple(torch.empty_like(p[0]) for _ in range(3))
    if n:
        args = scale_args(s)
        lib = build.load("group_ntt")
        build.check(lib.plonkit_g1_scale(*(t.data_ptr() for t in (*p, *out)), args.ctypes.data,
                                         n, *_group_of(n, p[0].device), stream_ptr(p[0])),
                    "K15 g1_scale")
        launches["g1_scale"] += 1
    return out


def split_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod q over [N, 8] Montgomery Fq rows on the card by
    K14 and K15's split product alone, two threads a row: the tests' hold
    on it beside K1's mul.  No plain version: gpu/mont.mont_mul is the
    same function."""
    check_operands(a, b)
    if not a.is_cuda:
        raise ValueError("the split product runs on the card only")
    out = torch.empty_like(a)
    if a.shape[0]:
        build.check(build.load("group_ntt").plonkit_fq_split_mul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], stream_ptr(a)),
            "split_mul")
    return out


# -- K16 ---------------------------------------------------------------------

def _points_in_operands(xy: torch.Tensor, inf: torch.Tensor) -> int:
    """n of a K16 call: xy [2n, 8] int32 (n x rows, then n y rows), inf [n]
    bool beside it, n a power of two."""
    check_operands(xy)
    n = xy.shape[0] // 2
    if (n < 1 or n & (n - 1) or xy.shape[0] != 2 * n or inf.dtype != torch.bool
            or inf.shape != (n,) or inf.device != xy.device or not inf.is_contiguous()):
        raise ValueError("K16 takes [2n, 8] int32 x and y rows and an [n] bool inf beside "
                         "them, n a power of two")
    return n


def g1_points_in_plain(xy: torch.Tensor, inf: torch.Tensor) -> torch.Tensor:
    """K16's plain version: the points in Montgomery form (gpu/mont.py's
    to_mont), Z one, all zero where inf is set, point i scattered to row
    rev(i) (ntt.bit_reversal) as each of K16's threads writes it."""
    n = _points_in_operands(xy, inf)
    keep = ~inf[:, None]
    pts = torch.zeros((3, n, NLIMBS), dtype=torch.int32, device=xy.device)
    xy_m = mont.to_mont(FQ, xy)
    for c, v in enumerate((xy_m[:n], xy_m[n:], FQ.one(xy.device).expand(n, NLIMBS))):
        pts[c] = torch.where(keep, v, 0)
    out = torch.empty_like(pts)
    out[:, torch.from_numpy(gntt.bit_reversal(n)).to(xy.device)] = pts
    return out


def g1_points_in(xy: torch.Tensor, inf: torch.Tensor) -> torch.Tensor:
    """K16: the [3, n, 8] Jacobian buffer group_intt's first stage reads,
    from the n points' canonical x and y rows (xy [2n, 8], x then y) and
    inf [n] bool: X = x R, Y = y R, Z = R mod q (Montgomery form), all zero
    where inf is set, point i at row i with its log2(n) bits reversed.  One
    launch."""
    if not xy.is_cuda:
        return g1_points_in_plain(xy, inf)
    n = _points_in_operands(xy, inf)
    out = torch.empty((3, n, NLIMBS), dtype=torch.int32, device=xy.device)
    build.check(build.load("group_ntt").plonkit_g1_points_in(
        xy.data_ptr(), xy[n:].data_ptr(), inf.data_ptr(), out.data_ptr(), n,
        FQ.words[1].ctypes.data, FQ.words[2].ctypes.data, stream_ptr(xy)), "K16 g1_points_in")
    launches["g1_points_in"] += 1
    return out


# -- the transform -------------------------------------------------------------

def _upload_in(x, y, inf, base: int, device) -> tuple:
    """One copy to the device of all a transform reads from the host: its
    points' x and y rows (canonical Fq), one canonical Fr row of the
    twiddles' base and inf's bytes, as one int32 buffer.  Returns the
    device's views: (xy [2n, 8], base [1, 8], inf [n] bool)."""
    n = x.shape[0]
    rows = 2 * n + 1
    buf = np.empty(rows * NLIMBS + -(-n // 4), dtype=np.uint32)
    limbs = buf[:rows * NLIMBS].reshape(rows, NLIMBS)
    limbs[:n], limbs[n:2 * n], limbs[2 * n] = x, y, FR.to_limbs_np([base])[0]
    flags = buf[rows * NLIMBS:].view(np.uint8)
    flags[:n], flags[n:] = inf, 0
    dev = mont.upload(buf.view(np.int32), device)
    limbs = dev[:rows * NLIMBS].view(rows, NLIMBS)
    return (limbs[:2 * n], limbs[2 * n:],
            dev[rows * NLIMBS:].view(torch.uint8)[:n].view(torch.bool))


def group_intt(x, y, inf, device="cuda"):
    """The inverse NTT over G1 of n = 2^k affine points given as canonical
    limb rows (x, y [n, 8] uint32, inf [n] bool: load_crs_g1_limbs's
    layout): out_i = (1/n) sum_j [w^-ij] P_j for the domain's root w, in the
    same layout.  For SRS points tau^j G these are L_i(tau) G.  One copy
    in (_upload_in) and one out (affine_batch_to_limbs), and nothing kept
    from one call to the next but the fields' constant rows.  K16 makes
    the [3, n, 8] Jacobian buffer in Montgomery form and bit-reversed order
    from the uploaded rows, K17 (field_kernels.field_powers) the canonical
    powers w^-j, j < n/2, from the uploaded w^-1; then the transposed Pease
    form of gpu/ntt.py's intt, over G1: k K14 stages, each reading the even
    and odd rows of one buffer and writing the halves of the other, with
    the stage twiddles of those powers, one K15 by 1/n, and the affine
    conversion of gpu/fixed_base.py (two K12 and one K13 for the inverse
    of Z, K1)."""
    n = x.shape[0]
    if n < 1 or n & (n - 1) or y.shape[0] != n or len(inf) != n:
        raise ValueError(f"{n} points: the transform takes a power of two of them")
    half = n // 2
    with span("lagrange key: points in"):
        xy, w_inv, at_inf = _upload_in(x, y, inf, fr_inv(get_domain_omega(n)), device)
        pts = g1_points_in(xy, at_inf)
    if half:
        with span("group ntt: twiddles"):
            tw = fk.field_powers(FR, w_inv, half)
        with span("group ntt: butterflies"):
            spare = torch.empty_like(pts)
            for t in reversed(range(n.bit_length() - 1)):
                g1_butterfly(tuple(c[0::2] for c in pts), tuple(c[1::2] for c in pts),
                             gntt._stage_twiddles(tw, t, half), out=tuple(spare))
                pts, spare = spare, pts
    with span("group ntt: scale"):
        pts = g1_scale(tuple(pts), fr_inv(n))
    with span("group ntt: affine"):
        aff = to_affine_batch(pts)
    with span("lagrange key: limbs out"):
        return affine_batch_to_limbs(aff)
