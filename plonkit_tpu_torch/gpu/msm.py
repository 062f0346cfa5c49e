"""Pippenger multi-scalar multiplication over BN254 G1 on the card, ported
from plonkit_tpu/tpu/msm.py (MSMContext).

One MSM over n fixed bases, with unsigned c-bit digits in W = ceil(254 / c)
windows:

1. the scalars leave Montgomery form by one K1 launch (x raw 1);
2. digits are taken with torch bit operations (as `_digits_packed`);
3. one `torch.sort` of int64 keys `(window * 2^c + digit) << idx_bits |
   index` orders every window's entries by bucket; zero digits (and bases at
   infinity) get a key above all others and drop out;
4. a segment table cuts each bucket's run into segments of at most
   SEGMENT entries (cumulative sums and binary searches: data movement,
   no host synchronisation);
5. K6 (bucket_sweep) sums each segment's bases;
6. K7r (segment_fold) folds a bucket's segment sums into its sum S_k in
   `fold_levels` levels: each level cuts every bucket's run of partial sums
   into groups of at most `group` (as step 4 cuts entries) and sums each
   group in order; the last level writes S_k to row window * 2^c + digit of
   a [W * 2^c] table whose other rows are infinity.  The level count,
   ceil(log_group(ceil(n / SEGMENT))), is fixed by n, so no level waits for
   the host to size it;
7. K7w (window_sums) computes sum_k k * S_k for all windows at once in
   levels of chunk walks over WINDOW_CHUNK items (the weighted chain of
   chunk totals goes up a level, the plain sum of the chunks' weighted
   parts beside it), and one K7 (padd) joins the two parts per window;
8. K8 (combine) adds the windows by Horner, one launch for a queued
   group of MSMs (msm_vec_end_many: a thread per MSM);
9. the group's Jacobian points come to the host in one copy and are made
   affine there.

Steps 1-7 queue on the device and wait for nothing (msm_vec_begin);
steps 8-9 resolve one MSM or a queued group (msm_vec_end,
msm_vec_end_many).  Steps 5-8 launch kernels on CUDA tensors and take
their plain versions on CPU ones (gpu/msm_kernels.py), so the same code
runs the CPU tests.  At 2^20 points (c = 12, group 32) a commitment
launches K7r 3, K7w 3 and K7 once.

What the reference does for its TPU layout and this port does not take
over:
- the u16-packed 64 B rows and the 8-point block transposes
  (`build_packed_table`, `_phase_a`, `_phase_b_flat`): they serve XLA's
  row gather and the TPU's (8, 128) tiles; here a thread gathers its rows
  by index from an [n, 16] table of x || y;
- the per-lane `r_max` tiers and their overflow retry (`window_configs`):
  a lane there owns a whole bucket in a padded run, and a skewed bucket
  overflows it; here a bucket is as many segments as it needs;
- the host fallback on overflow or on a degenerate flag (`_host_fallback`,
  `_finish`): segments cannot overflow and every add is complete, so there
  is no flag to react to and no path by which a commitment leaves the card.

The sort key packs a bucket and an index into one int64; the constructor
raises unless both fit under the key reserved for dropped entries (the
reference packs 12 + 20 bits into a u32 and asserts c + 20 <= 32).

Window width: c = clamp(bit_length(n) - 9, 4, 12), so c = 12 (W = 22, the
reference's choice) at 2^20 points.  A larger c makes fewer mixed adds
(n * W of them in K6) but 2^c buckets a window to reduce (about 2 W * 2^c
adds in K7w); at small n it keeps the reduction and the CPU tests cheap.
"""

import torch

from ..fields import FR_MODULUS
from ..profiling import stage
from . import ec, field_kernels as fk
from . import msm_kernels as mk
from .mont import FR, NLIMBS, to_tensor

SEGMENT = 32                  # entries per K6 segment at most
FOLD_GROUP = 32               # partial sums per K7r group at most
WINDOW_CHUNK = 16             # items per K7w chunk
SCALAR_BITS = 254
_DROPPED = (1 << 63) - 1      # sort key of zero digits: above every bucket


def window_bits(n: int) -> int:
    return max(4, min(12, n.bit_length() - 9))


def _run_starts(first: torch.Tensor, max_runs: int) -> torch.Tensor:
    """For every position, the position where its run begins; `first` flags
    the first element of each run, and there are at most max_runs runs.
    A cumulative sum numbers the runs and a binary search finds their
    starts (torch.cummax over the flagged positions does the same, but its
    CUDA scan took 35 ms at 2.3e7 entries on the H100)."""
    count = torch.cumsum(first, 0)
    starts = torch.searchsorted(count, torch.arange(1, max_runs + 1, device=first.device))
    return starts[(count - 1).clamp(min=0)]


class MSMContext:
    """Device-resident bases for repeated MSMs over one SRS."""

    def __init__(self, points, device="cuda", c: int = None, group: int = FOLD_GROUP):
        x, y, inf = ec.affine_from_host(list(points), device)
        self._init(x, y, inf, c, group)

    @classmethod
    def from_device_affine(cls, x, y, inf, c: int = None) -> "MSMContext":
        """From [n, 8] Montgomery Fq coordinate rows and the [n] infinity
        mask, all on one device."""
        ctx = cls.__new__(cls)
        ctx._init(x, y, inf, c, FOLD_GROUP)
        return ctx

    def _init(self, x, y, inf, c, group):
        self.n = x.shape[0]
        self.device = x.device
        self.c = window_bits(self.n) if c is None else c
        self.num_windows = -(-SCALAR_BITS // self.c)
        self.table = torch.cat([x, y], dim=1).contiguous()          # [n, 16]
        self.inf = inf.to(torch.bool) if bool(inf.any()) else None
        self.idx_bits = max(1, (self.n - 1).bit_length())
        buckets = self.num_windows << self.c
        # the packed key: bucket << idx_bits | index, below _DROPPED
        if buckets.bit_length() + self.idx_bits > 62:
            raise ValueError(f"c = {self.c} and {self.n} points do not fit one int64 sort key")
        if group < 2:
            raise ValueError(f"fold group {group} < 2")
        self.group = group
        # a bucket holds at most n entries, so ceil(n / SEGMENT) segments,
        # and after the last level at most one partial sum
        self.fold_levels, reach = 1, group
        while reach < -(-self.n // SEGMENT):
            self.fold_levels, reach = self.fold_levels + 1, reach * group

    # -- steps 2-4: digits, sort, segments --------------------------------

    def _sorted_keys(self, raw: torch.Tensor) -> torch.Tensor:
        """[m, 8] canonical scalar rows -> [W * m] sorted int64 keys."""
        m, c = raw.shape[0], self.c
        limbs = raw.to(torch.int64) & 0xFFFFFFFF
        digits = []
        for w in range(self.num_windows):
            bit0 = w * c
            limb, off = bit0 >> 5, bit0 & 31
            v = limbs[:, limb] >> off
            if off + c > 32 and limb + 1 < NLIMBS:
                v = v | (limbs[:, limb + 1] << (32 - off))
            digits.append(v & ((1 << c) - 1))
        d = torch.stack(digits)                                      # [W, m]
        win = torch.arange(self.num_windows, device=raw.device, dtype=torch.int64)
        idx = torch.arange(m, device=raw.device, dtype=torch.int64)
        keys = (((win[:, None] << c) | d) << self.idx_bits) | idx[None]
        drop = d == 0
        if self.inf is not None:
            drop = drop | self.inf[:m][None]
        keys = torch.where(drop, torch.full_like(keys, _DROPPED), keys)
        return torch.sort(keys.reshape(-1)).values

    def _segments(self, keys: torch.Tensor, m: int):
        """Cut each bucket's run of sorted keys into segments of at most
        SEGMENT entries.  Returns (idx [E] int32, seg_start, seg_len,
        seg_bucket [M] int64; unused segments have length 0 and bucket -1)."""
        e = keys.shape[0]
        dev = keys.device
        valid = keys != _DROPPED
        n_valid = valid.sum()
        bucket = keys >> self.idx_bits
        pos = torch.arange(e, device=dev)
        new_bucket = valid & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                        bucket[1:] != bucket[:-1]])
        buckets = self.num_windows << self.c
        rank = pos - _run_starts(new_bucket, buckets)
        is_seg = valid & (rank % SEGMENT == 0)
        count = torch.cumsum(is_seg, 0)
        m_seg = min(e, -(-e // SEGMENT) + buckets)
        seg_start = torch.searchsorted(count, torch.arange(1, m_seg + 1, device=dev))
        seg_end = torch.minimum(torch.cat([seg_start[1:], seg_start.new_full((1,), e)]),
                                n_valid)
        seg_len = (seg_end - seg_start).clamp(min=0)
        seg_bucket = torch.where(seg_len > 0, bucket[seg_start.clamp(max=e - 1)],
                                 torch.full_like(seg_start, -1))
        idx = (keys & ((1 << self.idx_bits) - 1)).to(torch.int32)
        return idx, seg_start.contiguous(), seg_len.contiguous(), seg_bucket

    # -- steps 6-8 -----------------------------------------------------------

    def _groups(self, bucket: torch.Tensor):
        """Cut each bucket's run of partial sums into groups of at most
        `group`, as _segments cuts entries.  bucket: [M] int64, sorted, with
        the unused rows (-1) at the end.  Returns (start, length,
        group_bucket), bounded as M / group + buckets, with unused groups
        of length 0 and bucket -1 at the end."""
        m = bucket.shape[0]
        dev = bucket.device
        valid = bucket >= 0
        first = valid & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                   bucket[1:] != bucket[:-1]])
        buckets = self.num_windows << self.c
        rank = torch.arange(m, device=dev) - _run_starts(first, buckets)
        count = torch.cumsum(valid & (rank % self.group == 0), 0)
        m_grp = min(m, -(-m // self.group) + buckets)
        start = torch.searchsorted(count, torch.arange(1, m_grp + 1, device=dev))
        end = torch.minimum(torch.cat([start[1:], start.new_full((1,), m)]), valid.sum())
        length = (end - start).clamp(min=0)
        group_bucket = torch.where(length > 0, bucket[start.clamp(max=m - 1)],
                                   torch.full_like(start, -1))
        return start.contiguous(), length.contiguous(), group_bucket

    def _bucket_table(self, sums, seg_bucket: torch.Tensor):
        """The segment sums folded into every bucket sum S_k by K7r levels,
        placed at window * 2^c + digit of a [W * 2^c] table whose other rows
        are infinity (all zeros)."""
        bucket = seg_bucket
        for _ in range(self.fold_levels - 1):
            start, length, bucket = self._groups(bucket)
            sums = mk.segment_fold(sums, start, length)
        start, length, bucket = self._groups(bucket)
        return mk.segment_fold(sums, start, length, bucket, self.num_windows << self.c)

    def _window_totals(self, buckets):
        """sum_k k * S_k for every window (rows w * 2^c + k): K7w levels
        until one chunk is left per window, then K7 adds its weighted part A
        and the carried plain part Q (infinity after a single level)."""
        k, t, p1, p2 = 1 << self.c, buckets, None, None
        while True:
            t, a, q = mk.window_sums(t, p1, p2, k, WINDOW_CHUNK)
            k = -(-k // WINDOW_CHUNK)
            if k == 1:
                break
            p1, p2 = a, q
        if q is None:
            q = ec.infinity(self.num_windows, a[0].device)
        return mk.padd(a, q)

    def _run(self, raw: torch.Tensor):
        """Steps 2-7 on [m, 8] canonical scalar rows: the W window totals
        as a Jacobian triple of [W, 8] rows on the device (nothing
        synchronises)."""
        m = raw.shape[0]
        if m > self.n:
            raise ValueError(f"{m} scalars for {self.n} bases")
        if m == 0:
            raw = torch.zeros((1, NLIMBS), dtype=torch.int32, device=raw.device)
            m = 1
        keys = self._sorted_keys(raw)
        idx, seg_start, seg_len, seg_bucket = self._segments(keys, m)
        sums = mk.bucket_sweep(self.table, idx, seg_start, seg_len)
        return self._window_totals(self._bucket_table(sums, seg_bucket))

    # -- entry points ----------------------------------------------------------

    def msm(self, scalars):
        """sum_i scalars[i] * bases[i] for python ints (len <= n); the host
        affine point (None for infinity)."""
        raw = to_tensor(FR.to_limbs_np([s % FR_MODULUS for s in scalars]), self.device)
        with stage("msm"):
            return self.msm_vec_end(self._run(raw))

    def msm_vec_begin(self, v_mont: torch.Tensor):
        """Queue steps 1-7 of the MSM of a device [N, 8] Montgomery Fr
        vector (N <= n) without synchronising: the handle is its window
        totals, which msm_vec_end or msm_vec_end_many resolve."""
        return self._run(fk.from_mont(FR, v_mont.contiguous()))

    def msm_vec_end_many(self, handles) -> list:
        """Steps 8-9 for a group of handles: one K8 launch over their
        stacked window totals, one copy of the points to the host; the
        affine points (None for infinity) in the handles' order."""
        if not handles:
            return []
        totals = tuple(torch.cat(parts) for parts in zip(*handles))
        points = torch.stack(mk.combine(totals, self.c, len(handles))).cpu()
        return ec.to_affine_host(tuple(points))

    def msm_vec_end(self, handle):
        return self.msm_vec_end_many([handle])[0]

    def msm_vec(self, v_mont: torch.Tensor):
        with stage("msm"):
            return self.msm_vec_end(self.msm_vec_begin(v_mont))
