"""Wrappers of the elementwise field kernels K1 mul, K2a add, K2b sub and
K4 mul_add (csrc/field.cu), ported from plonkit_tpu/tpu/pallas_kernels.py
mul/add/sub/mul_add.

Operands are [N, 8] int32 contiguous tensors of one shape on one device
(gpu/mont.py layout).  A tensor on the CPU takes the plain version from
gpu/mont.py; a CUDA tensor launches the kernel on the current stream or
raises.  `launches` counts kernel launches, one per call that launched.
"""

import torch

from . import build, mont
from .mont import NLIMBS, FieldSpec

launches = {"mul": 0, "add": 0, "sub": 0, "mul_add": 0}


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


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(op: str, spec: FieldSpec, *ins: torch.Tensor) -> torch.Tensor:
    a = ins[0]
    out = torch.empty_like(a)
    if a.shape[0]:
        fn = getattr(build.load("field"), "plonkit_field_" + op)
        build.check(fn(*(t.data_ptr() for t in ins), out.data_ptr(), a.shape[0],
                       spec.kernel_id, stream_ptr(a)), f"K {op}")
        launches[op] += 1
    return out


def mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1: a * b * 2^-256 mod p."""
    check_operands(a, b)
    if not a.is_cuda:
        return mont.mont_mul(spec, a, b)
    return _launch("mul", spec, a, b)


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


# -- compositions over K1 ----------------------------------------------------

def prefix_products(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products by Hillis-Steele rounds, one K1 launch a
    round (backend_jax._prefix_products_body)."""
    n = x.shape[0]
    ones = spec.const(1, n, x.device)
    p = x
    for i in range(max(1, (n - 1).bit_length())):
        d = 1 << i
        p = mul(spec, p, torch.cat([ones[:d], p[:n - d]]))
    return p


def suffix_products(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """S_i = prod_{j>=i} x_j (Hillis-Steele)."""
    n = x.shape[0]
    ones = spec.const(1, n, x.device)
    p = x
    for i in range(max(1, (n - 1).bit_length())):
        d = 1 << i
        p = mul(spec, p, torch.cat([p[d:], ones[:d]]))
    return p


def batch_inverse(spec: FieldSpec, v: torch.Tensor) -> torch.Tensor:
    """Montgomery batch inversion of Montgomery rows, zeros mapping to
    zero (pallas_kernels.py batch_inverse): two product scans, one scalar
    inverse, two combining products.  The scalar inverse of the total is
    taken on the host (one 32-byte read back), where the JAX package runs a
    one-lane Fermat ladder on the device."""
    n = v.shape[0]
    one = spec.const(1, n, v.device)
    zero_mask = (v == 0).all(dim=1, keepdim=True)
    x = torch.where(zero_mask, one, v)
    pre = prefix_products(spec, x)
    suf = suffix_products(spec, x)
    total = spec.from_limbs_np(mont.to_numpy(
        mul(spec, pre[n - 1:n].contiguous(), spec.const_raw(1, 1, v.device))))[0]
    pre_excl = torch.cat([one[:1], pre[:n - 1]])
    suf_excl = torch.cat([suf[1:], one[:1]])
    out = mul(spec, pre_excl, suf_excl)
    out = mul(spec, out, spec.const(pow(total, -1, spec.p), n, v.device))
    return torch.where(zero_mask, torch.zeros_like(out), out)
