"""Wrappers of the MSM kernels K6 bucket_sweep, K7 padd, K7r segment_fold,
K7w window_sums and K8 combine (csrc/msm.cu), each beside its plain PyTorch
version.  K6, K7 and K8 are ported from plonkit_tpu/tpu/msm_pallas.py
sweep_flat, padd and combine; K7r and K7w replace the rounds of padd that
the reference's bucket fold (msm_pallas.py fold_round) and weighted
reduction (tpu/msm.py _reduce_weighted) run.

Points are Jacobian triples of [N, 8] int32 Montgomery Fq rows (gpu/ec.py).
A CPU tensor takes the plain version; a CUDA tensor launches the kernel on
the current stream or raises.  `launches` counts kernel launches, one per
call that launched.
"""

import torch

from ..profiling import register_launches
from . import build, ec
from .field_kernels import check_operands, stream_ptr
from .mont import NLIMBS

launches = {"bucket_sweep": 0, "padd": 0, "segment_fold": 0, "window_sums": 0, "combine": 0}
register_launches(launches)


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
    types and devices are checked here.  The values are the caller's to
    hold (gpu/msm.py builds them), since checking them would wait for the
    card on every launch: every index lies in its table, and the segments
    of rows 32 w .. 32 w + 31 lie in idx[seg_start[32 w]:][:32 * SEGMENT],
    which _segments' consecutive runs of at most SEGMENT entries, the empty
    ones last, do.  On the card a segment outside that window stops the
    kernel, and the next call that synchronises raises a CUDA error."""
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
    if table.data_ptr() % 16 or idx.data_ptr() % 16:
        raise ValueError("table and idx must be 16-byte aligned")
    m = seg_start.shape[0]
    out = tuple(torch.empty((m, NLIMBS), dtype=torch.int32, device=table.device)
                for _ in range(3))
    if m:
        lib = build.load("msm")
        build.check(lib.plonkit_bucket_sweep(
            table.data_ptr(), idx.data_ptr(), seg_start.data_ptr(), seg_len.data_ptr(),
            *(o.data_ptr() for o in out), m, idx.shape[0], stream_ptr(table)),
            "K6 bucket_sweep")
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


# -- K7r ---------------------------------------------------------------------

def segment_fold_plain(pts, start, length, dst=None, rows=None):
    """Group sums: out[t] = pts[start[t]] + ... + pts[start[t] + length[t]
    - 1], accumulated in that order from infinity by the complete add (step
    i adds to the groups longer than i, as each thread of the kernel does at
    its step i).  With dst, group t goes to row dst[t] of a [rows] table of
    infinities instead, and groups with dst[t] < 0 are dropped."""
    m = start.shape[0]
    dev = pts[0].device
    acc = ec.infinity(m, dev)
    for i in range(int(length.max()) if m else 0):
        act = length > i
        part = ec.add(tuple(a[act] for a in acc), tuple(p[start[act] + i] for p in pts))
        acc = tuple(a.clone() for a in acc)
        for a, s in zip(acc, part):
            a[act] = s
    if dst is None:
        return acc
    out = ec.infinity(rows, dev)
    keep = dst >= 0
    for o, a in zip(out, acc):
        o[dst[keep]] = a[keep]
    return out


def segment_fold(pts, start, length, dst=None, rows=None):
    """K7r.  pts: M0 Jacobian points; start, length: [M] int64 groups of
    consecutive points (length 0 for none).  Returns the M group sums, or
    with dst ([M] int64) a [rows] table holding group t at row dst[t] (rows
    no group names are infinity; dst[t] < 0 drops group t).  That the groups
    lie in pts and that dst names each row at most once is the caller's to
    hold (gpu/msm.py builds them)."""
    check_operands(*pts)
    _check_vector(start, torch.int64, "start")
    _check_vector(length, torch.int64, "length")
    if start.shape != length.shape:
        raise ValueError("start and length differ in length")
    if dst is not None:
        _check_vector(dst, torch.int64, "dst")
        if dst.shape != start.shape or rows is None or rows < 0:
            raise ValueError("dst needs the groups' length and a row count")
    if len({t.device for t in (pts[0], start, length, dst) if t is not None}) != 1:
        raise ValueError("operands on different devices")
    if not pts[0].is_cuda:
        return segment_fold_plain(pts, start, length, dst, rows)
    m = start.shape[0]
    dev = pts[0].device
    if dst is None:
        out = tuple(torch.empty((m, NLIMBS), dtype=torch.int32, device=dev) for _ in range(3))
    else:
        out = ec.infinity(rows, dev)
    if m:
        lib = build.load("msm")
        build.check(lib.plonkit_segment_fold(
            *(t.data_ptr() for t in (*pts, start, length)),
            dst.data_ptr() if dst is not None else None,
            *(o.data_ptr() for o in out), m, stream_ptr(pts[0])), "K7r segment_fold")
        launches["segment_fold"] += 1
    return out


# -- K7w ---------------------------------------------------------------------

def _chunk_columns(p, k_in: int, chunk: int):
    """[W * k_in] points -> [W * k_out, chunk] per coordinate, each window's
    items padded with infinity to k_out * chunk."""
    w = p[0].shape[0] // k_in
    k_out = -(-k_in // chunk)
    out = []
    for a in p:
        pad = torch.zeros((w, k_out * chunk, NLIMBS), dtype=a.dtype, device=a.device)
        pad[:, :k_in] = a.reshape(w, k_in, NLIMBS)
        out.append(pad.reshape(w * k_out, chunk, NLIMBS))
    return out


def window_sums_plain(t, p1, p2, k_in: int, chunk: int):
    """One level of the weighted sums, over each window's k_in items cut
    into chunks of `chunk` (missing items are infinity).  For chunk j:
    A_j = sum_i i * t_{j chunk + i} by the walk R += t_i, A += R for i =
    chunk - 1 .. 1, then R += t_0; T_j = chunk * R (log2 chunk doublings);
    Q_j = sum_i (p1_i + p2_i) in that order from infinity, or None when p1
    and p2 are both None.  Returns (T, A, Q), [W * ceil(k_in / chunk)]
    points each; adding infinity changes no limb, so the padded steps give
    the kernel's values."""
    cols = _chunk_columns(t, k_in, chunk)
    n = cols[0].shape[0]
    dev = t[0].device

    def col(c3, i):
        return tuple(c[:, i].contiguous() for c in c3)

    r, a = ec.infinity(n, dev), ec.infinity(n, dev)
    for i in range(chunk - 1, 0, -1):
        r = ec.add(r, col(cols, i))
        a = ec.add(a, r)
    r = ec.add(r, col(cols, 0))
    for _ in range(chunk.bit_length() - 1):
        r = ec.double(r)
    plains = [_chunk_columns(p, k_in, chunk) for p in (p1, p2) if p is not None]
    q = None
    if plains:
        q = ec.infinity(n, dev)
        for i in range(chunk):
            for c3 in plains:
                q = ec.add(q, col(c3, i))
    return r, a, q


def window_sums(t, p1, p2, k_in: int, chunk: int):
    """K7w: one level of sum_k k * S_k over windows of k_in items each (see
    window_sums_plain).  t: Jacobian [W * k_in]; p1, p2: the same shape or
    None; chunk: a power of two >= 2."""
    check_operands(*t)
    for p in (p1, p2):
        if p is not None:
            check_operands(*t, *p)
    n = t[0].shape[0]
    if k_in < 1 or n % k_in or n == 0:
        raise ValueError(f"window_sums: {n} items are not whole windows of {k_in}")
    if chunk < 2 or chunk & (chunk - 1):
        raise ValueError(f"window_sums: chunk {chunk} is not a power of two >= 2")
    if not t[0].is_cuda:
        return window_sums_plain(t, p1, p2, k_in, chunk)
    chunks = n // k_in * -(-k_in // chunk)
    dev = t[0].device

    def fresh():
        return tuple(torch.empty((chunks, NLIMBS), dtype=torch.int32, device=dev)
                     for _ in range(3))

    out_t, out_a = fresh(), fresh()
    out_q = fresh() if p1 is not None or p2 is not None else None
    ptrs = [x.data_ptr() for x in t]
    for p in (p1, p2, out_t, out_a, out_q):
        ptrs += [None] * 3 if p is None else [x.data_ptr() for x in p]
    lib = build.load("msm")
    build.check(lib.plonkit_window_sums(*ptrs, chunks, k_in, chunk, chunk.bit_length() - 1,
                                       stream_ptr(t[0])), "K7w window_sums")
    launches["window_sums"] += 1
    return out_t, out_a, out_q


# -- K8 ----------------------------------------------------------------------

def combine_plain(w, c: int, batch: int = 1):
    """For each of `batch` MSMs, its W = rows / batch window totals
    (consecutive rows) combined as sum_w 2^(c w) * P_w by Horner from the
    top window: c doublings and one complete add per window, as
    tpu/msm.py:_combine_body, on all the MSMs' rows at once (the kernel's
    thread b walks row b).  Doubling X = Y = Z = 0 gives X = Y = Z = 0, so
    the doublings are skipped while every accumulator is infinity."""
    num = w[0].shape[0] // batch
    stacks = tuple(a.reshape(batch, num, NLIMBS) for a in w)
    acc = tuple(a[:, num - 1].contiguous() for a in stacks)
    for i in range(num - 2, -1, -1):
        if bool(torch.cat(acc, dim=1).any()):
            for _ in range(c):
                acc = ec.double(acc)
        acc = ec.add(acc, tuple(a[:, i].contiguous() for a in stacks))
    return acc


def combine(w, c: int, batch: int = 1):
    """K8: `batch` MSMs' window totals, W consecutive Jacobian rows each
    ([batch * W, 8] per coordinate) -> [batch, 8] Jacobian points, one
    launch for all of them (a thread per MSM)."""
    check_operands(*w)
    rows = w[0].shape[0]
    if batch < 1 or rows < batch or rows % batch or c < 1:
        raise ValueError(f"combine: {rows} rows are not {batch} stacks of at least one "
                         f"window, or c = {c} < 1")
    if not w[0].is_cuda:
        return combine_plain(w, c, batch)
    out = tuple(torch.empty((batch, NLIMBS), dtype=torch.int32, device=w[0].device)
                for _ in range(3))
    lib = build.load("msm")
    build.check(lib.plonkit_combine(*(t.data_ptr() for t in w), batch, rows // batch, c,
                                    *(o.data_ptr() for o in out), stream_ptr(w[0])),
                "K8 combine")
    launches["combine"] += 1
    return out
