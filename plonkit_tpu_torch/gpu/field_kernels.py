"""Wrappers of the elementwise field kernels K1 mul, K2a add, K2b sub and
K4 mul_add (csrc/field.cu), ported from plonkit_tpu/tpu/pallas_kernels.py
mul/add/sub/mul_add; of K1 by one constant row (mul_row) and the
Montgomery conversions over it (to_mont, from_mont), the port's one way
into and out of Montgomery form on the device; of K17 field_powers (the
canonical powers of one row); and of the field scans K12
field_scan and K13 field_inverse (csrc/scan.cu), which carry the JAX
package's scans (backend_jax.py prefix and suffix products, suffix sums)
and pallas_kernels.py batch_inverse.

Operands are [N, 8] int32 contiguous tensors of one shape on one device
(gpu/mont.py layout).  A tensor on the CPU takes the plain version from
gpu/mont.py; a CUDA tensor launches the kernel on the current stream or
raises.  `launches` counts kernel launches, one per call that launched.
"""

import torch

from ..profiling import register_launches
from . import build, mont
from .mont import NLIMBS, FieldSpec

launches = {"mul": 0, "add": 0, "sub": 0, "mul_add": 0, "scan": 0, "inverse": 0,
            "field_powers": 0}
register_launches(launches)


def check_operands(*ts: torch.Tensor) -> None:
    """Raise unless every tensor is [N, 8] int32, contiguous, of one shape
    and on one device (16-byte aligned rows on the card)."""
    first = ts[0]
    for t in ts:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != NLIMBS:
            raise ValueError(f"expected [N, {NLIMBS}] int32, got {t.dtype} {tuple(t.shape)}")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError("operands differ in shape or device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
        if t.is_cuda and t.data_ptr() % 16:
            raise ValueError("operand rows must be 16-byte aligned")


def _check_row(row: torch.Tensor) -> None:
    if row.dtype != torch.int32 or tuple(row.shape) != (1, NLIMBS):
        raise ValueError(f"expected a [1, {NLIMBS}] int32 row, got {row.dtype} {tuple(row.shape)}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(op: str, spec: FieldSpec, *ins: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    a = ins[0]
    if out is None:
        out = torch.empty_like(a)
    if a.shape[0]:
        fn = getattr(build.load("field"), "plonkit_field_" + op)
        build.check(fn(*(t.data_ptr() for t in ins), out.data_ptr(), a.shape[0],
                       spec.kernel_id, stream_ptr(a)), f"K {op}")
        launches[op] += 1
    return out


def mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor,
        out: torch.Tensor = None) -> torch.Tensor:
    """K1: a * b * 2^-256 mod p, written into `out` (an operand like a and
    b, such as a slice of rows of a larger buffer) where it is given."""
    check_operands(a, b, *(() if out is None else (out,)))
    if not a.is_cuda:
        prod = mont.mont_mul(spec, a, b)
        return prod if out is None else out.copy_(prod)
    return _launch("mul", spec, a, b, out=out)


def mul_row(spec: FieldSpec, a: torch.Tensor, row: torch.Tensor,
            out: torch.Tensor = None) -> torch.Tensor:
    """K1 of every row of a by one [1, 8] row (FieldSpec.row, r2, raw1 or
    one).  The port's one place that makes a row's broadcast operand: K1
    reads an [N, 8] copy of it."""
    _check_row(row)
    return mul(spec, a, row.expand(a.shape[0], NLIMBS).contiguous(), out=out)


def to_mont(spec: FieldSpec, raw: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """Canonical rows into Montgomery form: K1 by R^2."""
    return mul_row(spec, raw, spec.r2(raw.device), out=out)


def from_mont(spec: FieldSpec, m: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """Montgomery rows out to canonical ones: K1 by the integer 1."""
    return mul_row(spec, m, spec.raw1(m.device), out=out)


def field_powers_plain(spec: FieldSpec, base: torch.Tensor, n: int) -> torch.Tensor:
    """K17's plain version: square and multiply over all j < n at once,
    right to left over j's bits, in Montgomery form."""
    _check_row(base)
    if not n:
        return torch.empty((0, NLIMBS), dtype=torch.int32, device=base.device)
    j = torch.arange(n, device=base.device)
    acc = spec.one(base.device).expand(n, NLIMBS)
    sq = mont.to_mont(spec, base)
    for k in range((n - 1).bit_length()):
        hit = ((j >> k) & 1).bool()[:, None]
        acc = torch.where(hit, mont.mont_mul(spec, acc, sq.expand(n, NLIMBS)), acc)
        sq = mont.mont_mul(spec, sq, sq)
    return mont.from_mont(spec, acc.contiguous())


def field_powers(spec: FieldSpec, base: torch.Tensor, n: int) -> torch.Tensor:
    """K17: [n, 8] canonical rows base^j for j < n, from one canonical [1,
    8] row base below p, on base's device: one launch, each thread its own
    square and multiply over j's bits."""
    _check_row(base)
    if not base.is_cuda:
        return field_powers_plain(spec, base, n)
    if base.data_ptr() % 16:
        raise ValueError("operand rows must be 16-byte aligned")
    out = torch.empty((n, NLIMBS), dtype=torch.int32, device=base.device)
    if n:
        build.check(build.load("field").plonkit_field_powers(
            base.data_ptr(), out.data_ptr(), n, spec.kernel_id, spec.words[1].ctypes.data,
            stream_ptr(base)), "K17 field_powers")
        launches["field_powers"] += 1
    return out


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K2a: (a + b) mod p."""
    check_operands(a, b)
    if not a.is_cuda:
        return mont.add(spec, a, b)
    return _launch("add", spec, a, b)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K2b: (a - b) mod p."""
    check_operands(a, b)
    if not a.is_cuda:
        return mont.sub(spec, a, b)
    return _launch("sub", spec, a, b)


def mul_add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """K4: a * b * 2^-256 + c mod p, one launch for the pair mul, add."""
    check_operands(a, b, c)
    if not a.is_cuda:
        return mont.mul_add(spec, a, b, c)
    return _launch("mul_add", spec, a, b, c)


# -- K12 field_scan and K13 field_inverse (csrc/scan.cu) --------------------

SCAN_TILE = 4096            # rows a K12 tile (csrc/scan.cu kTile)
_SCAN_OPS = {"mul": 0, "add": 1}
_REVERSE, _EXCLUSIVE, _ZERO_AS_ONE, _INVERSE_EPILOGUE = 1, 2, 4, 8


def _identity(spec: FieldSpec, op: str, device) -> torch.Tensor:
    if op == "mul":
        return spec.const(1, 1, device)
    return torch.zeros((1, NLIMBS), dtype=torch.int32, device=device)


def scan_plain(spec: FieldSpec, x: torch.Tensor, op: str = "mul", reverse: bool = False,
               exclusive: bool = False) -> torch.Tensor:
    """Plain version of K12: Hillis-Steele rounds over gpu/mont.py's
    mont_mul or add, as the JAX package's scans (backend_jax.py:145 and
    :167, the sums of :314)."""
    combine = {"mul": mont.mont_mul, "add": mont.add}[op]
    n = x.shape[0]
    if not n:
        return x.clone()
    ident = _identity(spec, op, x.device)
    p = x
    for i in range(max(1, (n - 1).bit_length())):
        d = min(1 << i, n)
        fill = ident.expand(d, NLIMBS)
        p = combine(spec, p, torch.cat([p[d:], fill] if reverse else [fill, p[:n - d]]))
    if exclusive:
        p = torch.cat([p[1:], ident] if reverse else [ident, p[:n - 1]])
    return p


def scan(spec: FieldSpec, x: torch.Tensor, op: str = "mul", reverse: bool = False,
         exclusive: bool = False) -> torch.Tensor:
    """K12: the scan of x's rows under `op` ("mul", the Montgomery product,
    or "add"), prefix or suffix (reverse), inclusive or exclusive (the
    identity is Montgomery one or zero): one launch."""
    check_operands(x)
    if op not in _SCAN_OPS:
        raise ValueError(f"scan: op {op!r}, expected mul or add")
    if not x.is_cuda:
        return scan_plain(spec, x, op, reverse, exclusive)
    flags = (_REVERSE if reverse else 0) | (_EXCLUSIVE if exclusive else 0)
    return _scan_launch(spec, x, op, flags)


def _scan_launch(spec: FieldSpec, x: torch.Tensor, op: str, flags: int,
                 pre: torch.Tensor = None, seed: torch.Tensor = None) -> torch.Tensor:
    n = x.shape[0]
    out = torch.empty_like(x)
    if n:
        tiles = -(-n // SCAN_TILE)
        # per tile: 16 words of values, one status word; and the counter
        scratch = torch.empty(17 * tiles + 1, dtype=torch.int32, device=x.device)
        fn = build.load("scan").plonkit_field_scan
        build.check(fn(x.data_ptr(), out.data_ptr(),
                       None if pre is None else pre.data_ptr(),
                       None if seed is None else seed.data_ptr(),
                       scratch.data_ptr(), scratch.numel(), n, spec.kernel_id,
                       _SCAN_OPS[op], flags, stream_ptr(x)), "K12 field_scan")
        launches["scan"] += 1
    return out


def inverse(spec: FieldSpec, a: torch.Tensor, steps: torch.Tensor = None) -> torch.Tensor:
    """K13: the inverse of each row (Montgomery in and out), zero mapping to
    zero; one thread a row.  On the card `steps`, an [N] int32 tensor, may
    take each row's steps (low 16 bits) and the bits k its almost inverse
    shifted out (high 16 bits)."""
    check_operands(a)
    if not a.is_cuda:
        return mont.inverse(spec, a)
    out = torch.empty_like(a)
    n = a.shape[0]
    if n:
        if steps is not None and (steps.dtype != torch.int32 or steps.shape != (n,)
                                  or steps.device != a.device):
            raise ValueError("inverse: steps must be an [N] int32 tensor beside a")
        fn = build.load("scan").plonkit_field_inverse
        build.check(fn(a.data_ptr(), out.data_ptr(),
                       None if steps is None else steps.data_ptr(), n, spec.kernel_id,
                       stream_ptr(a)), "K13 field_inverse")
        launches["inverse"] += 1
    return out


def prefix_products(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products (backend_jax._prefix_products_body)."""
    return scan(spec, x, "mul")


def suffix_products(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """S_i = prod_{j>=i} x_j (backend_jax._suffix_products_body)."""
    return scan(spec, x, "mul", reverse=True)


def batch_inverse_plain(spec: FieldSpec, v: torch.Tensor) -> torch.Tensor:
    """Plain version of batch_inverse: two product scans, the inverse of the
    total on the host (one 32-byte read back), two combining products."""
    n = v.shape[0]
    if not n:
        return v.clone()
    one = spec.const(1, n, v.device)
    zero_mask = (v == 0).all(dim=1, keepdim=True)
    x = torch.where(zero_mask, one, v)
    pre = scan_plain(spec, x, "mul")
    suf = scan_plain(spec, x, "mul", reverse=True)
    total = spec.from_limbs_np(mont.to_numpy(mont.from_mont(spec, pre[n - 1:n])))[0]
    pre_excl = torch.cat([one[:1], pre[:n - 1]])
    suf_excl = torch.cat([suf[1:], one[:1]])
    out = mont.mont_mul(spec, pre_excl, suf_excl)
    out = mont.mont_mul(spec, out, spec.const(pow(total, -1, spec.p), n, v.device))
    return torch.where(zero_mask, torch.zeros_like(out), out)


def batch_inverse(spec: FieldSpec, v: torch.Tensor) -> torch.Tensor:
    """Montgomery batch inversion of Montgomery rows, zeros mapping to zero
    (pallas_kernels.py batch_inverse).  On the card three launches and no
    read back: K12, the inclusive prefix products P of v with zeros read as
    one; K13, T^-1 for the total T = P[n-1]; K12, the exclusive suffix
    products seeded with T^-1, each times P_{i-1}: out_i = P_{i-1} *
    S_{i+1} * T^-1 = v_i^-1."""
    check_operands(v)
    if not v.is_cuda:
        return batch_inverse_plain(spec, v)
    n = v.shape[0]
    if not n:
        return torch.empty_like(v)
    pre = _scan_launch(spec, v, "mul", _ZERO_AS_ONE)
    total_inv = inverse(spec, pre[n - 1:])
    return _scan_launch(spec, v, "mul", _REVERSE | _EXCLUSIVE | _ZERO_AS_ONE | _INVERSE_EPILOGUE,
                        pre=pre, seed=total_inv)
