"""Wrappers of the MSM kernels K6 bucket_sweep, K7 padd and K8 combine
(csrc/msm.cu), ported from plonkit_tpu/tpu/msm_pallas.py sweep_flat, padd
and combine, each beside its plain PyTorch version.

Points are Jacobian triples of [N, 8] int32 Montgomery Fq rows (gpu/ec.py).
A CPU tensor takes the plain version; a CUDA tensor launches the kernel on
the current stream or raises.  `launches` counts kernel launches, one per
call that launched.
"""

import torch

from . import build, ec
from .field_kernels import check_operands, stream_ptr
from .mont import NLIMBS

launches = {"bucket_sweep": 0, "padd": 0, "combine": 0}


def _check_vector(t: torch.Tensor, dtype, name: str) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 1-d {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")


# -- K6 ----------------------------------------------------------------------

def bucket_sweep_plain(table, idx, seg_start, seg_len):
    """Segment sums: out[t] = sum of the affine rows table[idx[seg_start[t]
    + i]] for i < seg_len[t], accumulated in that order from infinity by the
    complete mixed add.  Step i adds to the segments longer than i, which is
    what each thread of the kernel does at its step i."""
    m = seg_start.shape[0]
    acc = ec.infinity(m, table.device)
    steps = int(seg_len.max()) if m else 0
    for i in range(steps):
        act = seg_len > i
        rows = idx[seg_start[act] + i].long()
        x, y = table[rows, :NLIMBS].contiguous(), table[rows, NLIMBS:].contiguous()
        fin = torch.zeros(rows.shape[0], dtype=torch.bool, device=table.device)
        part = ec.add_mixed(tuple(a[act] for a in acc), (x, y, fin))
        acc = tuple(a.clone() for a in acc)
        for a, s in zip(acc, part):
            a[act] = s
    return acc


def bucket_sweep(table, idx, seg_start, seg_len):
    """K6.  table: [n, 16] int32 affine rows (x || y, Montgomery Fq, all
    finite); idx: [E] int32 row indices in sorted order; seg_start, seg_len:
    [M] int64 segments of idx.  Returns M Jacobian segment sums.  Shapes,
    types and devices are checked here; that every index lies in its table
    is the caller's to hold (gpu/msm.py builds them), since checking the
    values would wait for the card on every launch."""
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[1] != 2 * NLIMBS \
            or not table.is_contiguous():
        raise ValueError(f"table: expected [n, {2 * NLIMBS}] contiguous int32")
    _check_vector(idx, torch.int32, "idx")
    _check_vector(seg_start, torch.int64, "seg_start")
    _check_vector(seg_len, torch.int64, "seg_len")
    if seg_start.shape != seg_len.shape:
        raise ValueError("seg_start and seg_len differ in length")
    if len({t.device for t in (table, idx, seg_start, seg_len)}) != 1:
        raise ValueError("operands on different devices")
    if not table.is_cuda:
        return bucket_sweep_plain(table, idx, seg_start, seg_len)
    if table.data_ptr() % 16:
        raise ValueError("table rows must be 16-byte aligned")
    m = seg_start.shape[0]
    out = tuple(torch.empty((m, NLIMBS), dtype=torch.int32, device=table.device)
                for _ in range(3))
    if m:
        lib = build.load("msm")
        build.check(lib.plonkit_bucket_sweep(
            table.data_ptr(), idx.data_ptr(), seg_start.data_ptr(), seg_len.data_ptr(),
            *(o.data_ptr() for o in out), m, stream_ptr(table)), "K6 bucket_sweep")
        launches["bucket_sweep"] += 1
    return out


# -- K7 ----------------------------------------------------------------------

def padd_plain(p, q):
    return ec.add(p, q)


def padd(p, q):
    """K7: the complete Jacobian sum p + q, lane by lane."""
    check_operands(*p, *q)
    if not p[0].is_cuda:
        return padd_plain(p, q)
    n = p[0].shape[0]
    out = tuple(torch.empty_like(p[0]) for _ in range(3))
    if n:
        lib = build.load("msm")
        build.check(lib.plonkit_padd(*(t.data_ptr() for t in (*p, *q, *out)), n,
                                     stream_ptr(p[0])), "K7 padd")
        launches["padd"] += 1
    return out


# -- K8 ----------------------------------------------------------------------

def combine_plain(w, c: int):
    """sum_w 2^(c w) * P_w by Horner from the top window: c doublings and
    one complete add per window, as tpu/msm.py:_combine_body.  Doubling
    X = Y = Z = 0 gives X = Y = Z = 0, so those doublings are skipped."""
    num = w[0].shape[0]
    acc = tuple(a[num - 1:num] for a in w)
    for i in range(num - 2, -1, -1):
        if bool(torch.cat(acc, dim=1).any()):
            for _ in range(c):
                acc = ec.double(acc)
        acc = ec.add(acc, tuple(a[i:i + 1] for a in w))
    return acc


def combine(w, c: int):
    """K8: the W window totals w (Jacobian, [W, 8] each) -> one [1, 8]
    Jacobian point."""
    check_operands(*w)
    if w[0].shape[0] < 1 or c < 1:
        raise ValueError("combine: needs at least one window and c >= 1")
    if not w[0].is_cuda:
        return combine_plain(w, c)
    out = tuple(torch.empty((1, NLIMBS), dtype=torch.int32, device=w[0].device)
                for _ in range(3))
    lib = build.load("msm")
    build.check(lib.plonkit_combine(*(t.data_ptr() for t in w), w[0].shape[0], c,
                                    *(o.data_ptr() for o in out), stream_ptr(w[0])),
                "K8 combine")
    launches["combine"] += 1
    return out
