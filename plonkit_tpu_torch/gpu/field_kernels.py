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
