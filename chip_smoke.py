#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (plonkit_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py          # from the root of the repository

Phases, each printing a JSON line with its wall seconds:

1. build: the CUDA kernels (csrc/*.cu, one nvcc per source, all at once) and
   the native host library (native/bn254.cpp), with each kernel's
   registers, shared memory, stack and spills from ptxas and the
   instructions of K1 (one Montgomery product), K6 and K8 from the CUDA
   toolkit's cuobjdump, then the card's name and power limit as nvidia-smi
   reports them;
2. srs: the tau = 42 dev SRS of 2^20 points, made by the CLI's
   `setup -p 20` (srs.py, serial python); its first two points must be G
   and 42 G;
3. kernels: every kernel on the card against its plain PyTorch version on
   the card, on the same inputs, equal bit for bit (integer arithmetic):
   K1 mul, K2a add, K2b sub, K4 mul_add at 2^20 elements and K3
   butterfly_dif, K5 butterfly on 2^19 butterflies (random Montgomery Fr
   values from a fixed numpy seed, with 0, 1, p-1 and p-2 planted; K3 and
   K5 with a real stage's twiddles, K5 reading the even and odd rows of one
   buffer as the inverse transform does); K6 bucket_sweep on the
   segments of one MSM of 2^20 random scalars over the SRS bases (the main
   path's shape) and on the sorted window-0 entries of 2^16 of them, both
   with a planted bucket of more than four segments; K7 padd at 2^20 lanes with
   planted P + P, P + (-P), P + inf, inf + Q and inf + inf lanes; K7r
   segment_fold on the first fold level of that MSM's segment sums (timed),
   and on every level of the fold of 2^20 0/1 scalars (~2^19 entries in
   one bucket); K7w window_sums on the first level of that MSM's 22 x 4096
   bucket table (timed), and on every level; K8 combine in one launch over
   the 22 random Jacobian window totals (c = 12) of each of 11 MSMs;
4. msm: the device MSM (gpu/msm.MSMContext) over the 2^20 SRS bases
   against the native host Pippenger (backend.HostMSMContext) on four
   scalar vectors (uniform, 0/1, one constant, a single non-zero): the
   affine points must be equal, one MSM at a time and the four queued
   together and resolved by one K8 launch (msm_vec_end_many);
5. cross-check: a 2^10-domain synthetic prove on the card, its commitments
   on the card through the MSM kernels (launch counts read from that
   prove), gives vk.bin and proof.bin bytes identical to the same prove on
   the CPU (plain versions, commitments in the host Pippenger);
6. main path at a 2^20 domain: the synthetic multiplication chain,
   SetupForProver, make_verification_key, prove, verify, through the entry
   points a user calls, commitments on the card ("msm": "device"), with the
   launch count of every kernel read from that run alone, and the launches
   of the bucket reduction (K7r, K7w, K7) per commitment, at most 8, and
   one K8 launch for each group of commitments the backend was asked for
   (a commit_many call, or a single commit).  The proof must verify and a
   tampered copy must not.  The same setup then makes vk.bin
   and proof.bin again with every commitment in the host Pippenger (a
   TorchBackend subclass defined here): the bytes must be identical.  A
   last prove on the device setup runs under torch.profiler: device time by
   kernel, and the device's busy time and idle share over its wall time;
7. cli: `python3 -m plonkit_tpu_torch` in subprocesses, on the card, on the
   in-repo circuit scratch/recursive_r22 (domain 64): setup -p 10, analyse,
   export-verification-key (its vk.bin must equal the fixture's, made by the
   JAX package), prove (keccak), dump-lagrange and prove -l (the same
   proof.bin), verify (exit 0) and a tampered proof (exit 144),
   generate-verifier (no placeholder left);
8. cli at full width: the main path's circuit written as .r1cs and .wtns,
   then export-verification-key, prove and verify through the CLI: vk.bin
   and proof.bin must equal the main phase's bytes from the API.  No CLI
   process may rebuild a kernel library.  Phases 7 and 8 run at the same
   time, and so do the calls of each that need no file of another: their
   seconds are wall times of processes that share the host and the card.

Then the kernels line, the card line, and as the last line
{"ok": true, "device": {...}}.  Any failure raises: the exit code is not 0
and no result line is printed.  Without a CUDA device it stops at once.
"""

import contextlib
import copy
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 20240917
KERNEL_LOG2 = 20        # width of K1-K5 and K7
SWEEP_LOG2 = 16         # scalars of the K6 one-window check
CROSS_LOG2 = 10         # phase 5 domain
MAIN_LOG2 = 20          # phase 6 domain and SRS size
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth,
# and 32-bit integer multiplies: 64 lanes per SM per clock on sm_90, half
# the 128 FP32 lanes behind the 67 TFLOP/s float32 figure (2 flops per
# FMA), so 67e12 / 4.
HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 67e12 / 4

# 32-bit multiply instructions of one Montgomery product: 64 + 64 wide
# products of 2 instructions each, plus 8 for m = t0 * n0
MONT_MUL_OPS = 2 * (64 + 64) + 8
POINT_BYTES = 3 * 32                       # a Jacobian point, [3, 8] words
MADD_MULS, ADD_MULS, DBL_MULS = 11, 16, 7  # products of madd, add, double
REDUCTION_LAUNCHES_MAX = 8                 # K7r + K7w + K7 per commitment
K8_BATCH = 11                              # MSMs of the K8 row: the vk's group
REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "scratch", "recursive_r22")   # domain-64 circuit of phase 7
SOURCES = {
    "K1 mul": ("plonkit_tpu_torch/csrc/field.cu", "plonkit_tpu/tpu/pallas_kernels.py:149"),
    "K2a add": ("plonkit_tpu_torch/csrc/field.cu", "plonkit_tpu/tpu/pallas_kernels.py:153"),
    "K2b sub": ("plonkit_tpu_torch/csrc/field.cu", "plonkit_tpu/tpu/pallas_kernels.py:157"),
    "K3 butterfly_dif": ("plonkit_tpu_torch/csrc/ntt.cu",
                         "plonkit_tpu/tpu/pallas_kernels.py:169"),
    "K4 mul_add": ("plonkit_tpu_torch/csrc/field.cu", "plonkit_tpu/tpu/pallas_kernels.py:161"),
    "K5 butterfly": ("plonkit_tpu_torch/csrc/ntt.cu", "plonkit_tpu/tpu/pallas_kernels.py:165"),
    "K6 bucket_sweep": ("plonkit_tpu_torch/csrc/msm.cu", "plonkit_tpu/tpu/msm_pallas.py:166"),
    "K7 padd": ("plonkit_tpu_torch/csrc/msm.cu", "plonkit_tpu/tpu/msm_pallas.py:213"),
    "K7r segment_fold": ("plonkit_tpu_torch/csrc/msm.cu", "plonkit_tpu/tpu/msm_pallas.py:238"),
    "K7w window_sums": ("plonkit_tpu_torch/csrc/msm.cu", "plonkit_tpu/tpu/msm.py:304"),
    "K8 combine": ("plonkit_tpu_torch/csrc/msm.cu", "plonkit_tpu/tpu/msm_pallas.py:271"),
}


_print_lock = threading.Lock()


def emit(obj) -> None:
    with _print_lock:
        print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events,
    after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> None:
    from plonkit_tpu_torch import native
    from plonkit_tpu_torch.gpu import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        kern = pool.submit(build.build_all)
        host = pool.submit(native.build)
        log = kern.result()
        host.result()
    for name, rec in log.items():
        emit({"build": name, "nvcc_s": round(rec["seconds"], 3),
              "ptxas": ptxas_by_kernel(rec["ptxas"])})
    emit({"build": "sass", "field": sass_counts(build.library_path("field"), {"mul_kernel"}),
          "msm": sass_counts(build.library_path("msm"), {"bucket_sweep_kernel",
                                                         "combine_kernel"})})
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "kernels": [os.path.basename(build.library_path(n)) for n in build.SOURCES],
          "native": os.path.basename(native.library_path())})
    print(card_line(), flush=True)


def ptxas_by_kernel(report: str) -> dict:
    """ptxas -v output -> {kernel: registers, shared memory, stack and
    spill bytes (those of the device functions it calls included)}."""
    out, cur = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            short = re.search(r"(?<=\d)([a-z_]+_kernel)E", m.group(1))
            cur = short.group(1) if short else m.group(1)
            out[cur] = {"spill_bytes": 0}
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                out[cur]["spill_bytes"] += int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out[cur]["registers"] = int(m.group(1))
                for key, pat in (("stack_bytes", r"(\d+) bytes cumulative stack"),
                                 ("smem_bytes", r"(\d+) bytes smem")):
                    v = re.search(pat, ln)
                    out[cur][key] = int(v.group(1)) if v else 0
    return out


def sass_counts(lib: str, kernels) -> dict:
    """Instructions of the named kernels in a built library (cuobjdump
    -sass), in all and of the IMAD family."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    dump = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for sec in dump.split("Function : ")[1:]:
        short = re.search(r"(?<=\d)([a-z_]+_kernel)E", sec.split("\n", 1)[0])
        if short is None or short.group(1) not in kernels:
            continue
        ops = re.findall(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", sec,
                         re.M)
        out[short.group(1)] = {"instructions": len(ops),
                               "imad": sum(op.startswith("IMAD") for op in ops)}
    if set(out) != set(kernels):
        raise AssertionError(f"cuobjdump -sass {lib}: found {sorted(out)} of {sorted(kernels)}")
    return out


def cli(*args, cwd: str, expect: int = 0) -> float:
    """`python3 -m plonkit_tpu_torch *args` in a subprocess (the default
    backend, the card); raises unless it exits with `expect`.  Returns its
    wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "plonkit_tpu_torch", *args], cwd=cwd,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != expect:
        raise AssertionError(f"plonkit_tpu_torch {' '.join(args)} exited {proc.returncode}, "
                             f"expected {expect}:\n{proc.stderr[-4000:]}")
    return time.perf_counter() - t0


def cli_together(*calls, cwd: str) -> dict:
    """Several CLI processes at once, each (label, args) or (label, args,
    expect); returns {label: wall seconds}, raising if any call failed."""
    with ThreadPoolExecutor(len(calls)) as pool:
        futures = {c[0]: pool.submit(cli, *c[1], cwd=cwd, expect=c[2] if len(c) > 2 else 0)
                   for c in calls}
        return {label: f.result() for label, f in futures.items()}


def phase_srs(tmp: str) -> str:
    from plonkit_tpu_torch.curve import G1_GEN, g1_mul
    from plonkit_tpu_torch.gpu.mont import FQ
    from plonkit_tpu_torch.serialization import load_crs_g1_limbs
    t0 = time.perf_counter()
    key = os.path.join(tmp, f"srs_2pow{MAIN_LOG2}.key")
    cli("setup", "-p", str(MAIN_LOG2), "-m", key, cwd=tmp)
    x, y, inf = load_crs_g1_limbs(key, 2)
    pts = [None if inf[i] else (FQ.from_limbs_np(x[i:i + 1])[0], FQ.from_limbs_np(y[i:i + 1])[0])
           for i in range(2)]
    if pts != [G1_GEN, g1_mul(G1_GEN, 42)]:
        raise AssertionError("SRS points 0 and 1 are not G and 42*G")
    emit({"phase": "srs", "points": 1 << MAIN_LOG2, "seconds": round(time.perf_counter() - t0, 3)})
    return key


def _random_fr_rows(rng, n: int, planted_at: int = None) -> np.ndarray:
    """[n, 8] uint32 rows of random values below p (top limb below p's),
    with 0, 1, p-1, p-2 planted from row `planted_at` if it is given."""
    from plonkit_tpu_torch.gpu.mont import FR
    rows = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    rows[:, 7] %= np.uint32(FR.p32[7])
    if planted_at is not None:
        rows[planted_at:planted_at + 4] = FR.to_limbs_np([0, 1, FR.p - 1, FR.p - 2])
    return rows


def _timed_once(fn):
    """fn() and its device time in ms (CUDA events around one call)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _mismatches(got, want) -> int:
    return sum(int((g != w).any(dim=1).sum()) for g, w in zip(got, want))


def _row(name, kern, plain, count, bytes_moved, int32_muls, reps, warm_plain=True, **extra):
    """Run kernel and plain version, compare them, time both (the kernel
    over `reps` launches after a warm-up, the plain version on the call
    compared, after a warm-up call unless warm_plain is False), and reckon
    the bound from this input's bytes and 32-bit multiplies."""
    import torch
    got = kern()
    if warm_plain:
        plain()
    want, plain_ms = _timed_once(plain)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    mism = _mismatches(got, want)
    err = max(int(((g.to(torch.int64) & 0xFFFFFFFF) - (w.to(torch.int64) & 0xFFFFFFFF))
                  .abs().max()) for g, w in zip(got, want))
    bytes_s = bytes_moved / HBM_BYTES_PER_S
    ops_s = int32_muls / INT32_MUL_PER_S
    source, replaces = SOURCES[name]
    return dict({
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "elements": count, "mismatches": mism, "max_abs_err": err,
        "ms": time_ms(kern, reps), "plain_ms": plain_ms,
        "bound_ms": max(bytes_s, ops_s) * 1e3,
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "bound_bytes": bytes_moved, "bound_int32_muls": int32_muls,
        "bound_basis": "max(bytes / 3.35e12 B/s, int32 multiplies / 16.75e12 per s)",
        "library_ms": None,
    }, **extra)


def _field_rows() -> list:
    import torch
    from plonkit_tpu_torch.fields import fr_inv, get_domain_omega
    from plonkit_tpu_torch.gpu import field_kernels as fk, mont, ntt
    from plonkit_tpu_torch.gpu.mont import FR, to_tensor
    n = 1 << KERNEL_LOG2
    rng = np.random.default_rng(SEED)
    a = to_tensor(_random_fr_rows(rng, n, 0), DEVICE)
    b = to_tensor(_random_fr_rows(rng, n, n - 4), DEVICE)
    c = to_tensor(_random_fr_rows(rng, n, n // 2), DEVICE)
    # K3 on one stage of a 2^20-point NTT: lo/hi halves and the stage-1
    # twiddles w^(2 * (j >> 1))
    half = n // 2
    omega_pows = ntt.powers(get_domain_omega(n), half, DEVICE)
    tw = omega_pows[::2][:half >> 1].repeat_interleave(2, dim=0)
    lo, hi = a[:half], a[half:]
    # K5 on stage 1 of a 2^20-point inverse NTT: the even and odd rows of
    # one buffer, twiddles of w^-1
    inv_pows = ntt.powers(fr_inv(get_domain_omega(n)), half, DEVICE)
    tw_inv = inv_pows[::2][:half >> 1].repeat_interleave(2, dim=0)
    even, odd = b[0::2], b[1::2]
    out = torch.empty_like(b)

    def plain_bfly():
        return mont.add(FR, lo, hi), mont.mont_mul(FR, tw, mont.sub(FR, lo, hi))

    return [
        _row("K1 mul", lambda: fk.mul(FR, a, b), lambda: mont.mont_mul(FR, a, b), n,
             3 * 32 * n, MONT_MUL_OPS * n, 20),
        _row("K2a add", lambda: fk.add(FR, a, b), lambda: mont.add(FR, a, b), n,
             3 * 32 * n, 0, 20),
        _row("K2b sub", lambda: fk.sub(FR, a, b), lambda: mont.sub(FR, a, b), n,
             3 * 32 * n, 0, 20),
        _row("K3 butterfly_dif", lambda: ntt.butterfly_dif(lo, hi, tw), plain_bfly, half,
             5 * 32 * half, MONT_MUL_OPS * half, 20),
        _row("K4 mul_add", lambda: fk.mul_add(FR, a, b, c), lambda: mont.mul_add(FR, a, b, c), n,
             4 * 32 * n, MONT_MUL_OPS * n, 20),
        _row("K5 butterfly", lambda: ntt.butterfly(FR, even, odd, tw_inv, out),
             lambda: mont.butterfly(FR, even, odd, tw_inv), half,
             5 * 32 * half, MONT_MUL_OPS * half, 20),
    ]


def _segments_of(ctx, rows: np.ndarray, window0: bool = False):
    """The segment table the MSM builds for these scalar rows (all windows,
    or window 0 alone), and its entry and segment counts."""
    from plonkit_tpu_torch.gpu.mont import to_tensor
    keys = ctx._sorted_keys(to_tensor(rows, DEVICE))
    if window0:
        keys = keys[(keys >> ctx.idx_bits) < (1 << ctx.c)].contiguous()
    idx, seg_start, seg_len, seg_bucket = ctx._segments(keys, rows.shape[0])
    return (idx, seg_start, seg_len, seg_bucket,
            int(seg_len.sum()), int((seg_len > 0).sum()))



def _fold_all_levels(ctx, sums, seg_bucket) -> int:
    """Every K7r level against its plain version on the card, each level
    fed the kernel's output; the rows that differ."""
    from plonkit_tpu_torch.gpu import msm_kernels as mk
    bucket, bad = seg_bucket, 0
    for level in range(ctx.fold_levels):
        start, length, bucket = ctx._groups(bucket)
        last = (bucket, ctx.num_windows << ctx.c) if level == ctx.fold_levels - 1 else ()
        got = mk.segment_fold(sums, start, length, *last)
        bad += _mismatches(got, mk.segment_fold_plain(sums, start, length, *last))
        sums = got
    return bad


def _window_all_levels(ctx, table):
    """Every K7w level against its plain version on the card: the rows that
    differ, and the number of levels."""
    from plonkit_tpu_torch.gpu import msm_kernels as mk
    from plonkit_tpu_torch.gpu.msm import WINDOW_CHUNK
    k, t, p1, p2, bad, levels = 1 << ctx.c, table, None, None, 0, 0
    while k > 1:
        levels += 1
        got = mk.window_sums(t, p1, p2, k, WINDOW_CHUNK)
        want = mk.window_sums_plain(t, p1, p2, k, WINDOW_CHUNK)
        bad += sum(_mismatches(g, w) for g, w in zip(got, want) if g is not None)
        bad += sum((g is None) != (w is None) for g, w in zip(got, want))
        t, p1, p2 = got[0], got[1], got[2]
        k = -(-k // WINDOW_CHUNK)
    return bad, levels


def _weighted_walk_ops(finite, chunk: int) -> int:
    """Point adds with both operands finite, and doublings of a finite sum,
    that K7w's weighted walk makes over chunks whose items are finite where
    `finite` ([chunks, chunk] bool) says: 32-bit multiplies."""
    r = finite.new_zeros(finite.shape[0])
    a = r.clone()
    adds = 0
    for i in range(chunk - 1, -1, -1):
        f = finite[:, i]
        adds += int((r & f).sum())
        r = r | f
        if i:
            adds += int((a & r).sum())
            a = a | r
    dbls = int(r.sum()) * (chunk.bit_length() - 1)
    return (adds * ADD_MULS + dbls * DBL_MULS) * MONT_MUL_OPS


def _msm_rows(ctx) -> list:
    """K6, K7, K8 on the card against their plain versions on the card."""
    import torch
    from plonkit_tpu_torch.gpu import ec, msm_kernels as mk
    from plonkit_tpu_torch.gpu.mont import FR
    rng = np.random.default_rng(SEED + 1)
    # K6 at the main path's shape: the segments of one MSM of 2^20 uniform
    # scalars (all 22 windows), with a planted bucket (window 0, digit 7)
    rows = _random_fr_rows(rng, ctx.n, 0)
    hot = 7 * 32
    rows[4:4 + hot] = FR.to_limbs_np([7])
    idx, seg_start, seg_len, seg_bucket, entries, segs = _segments_of(ctx, rows)
    hot_segs = int((seg_bucket == 7).sum())
    if hot_segs <= 4:
        raise AssertionError(f"planted bucket has {hot_segs} segments")
    # and on the sorted window-0 entries of the first 2^16 scalars
    w0 = _segments_of(ctx, rows[:1 << SWEEP_LOG2], window0=True)
    w0_got = mk.bucket_sweep(ctx.table, *w0[:3])
    w0_want = mk.bucket_sweep_plain(ctx.table, *w0[:3])
    w0_mism = _mismatches(w0_got, w0_want)
    w0_hot = int((w0[3] == 7).sum())
    if w0_hot <= 4:
        raise AssertionError(f"planted bucket has {w0_hot} segments in the 2^16 window")
    k6 = _row("K6 bucket_sweep", lambda: mk.bucket_sweep(ctx.table, idx, seg_start, seg_len),
              lambda: mk.bucket_sweep_plain(ctx.table, idx, seg_start, seg_len), entries,
              entries * (64 + 4) + seg_start.shape[0] * (16 + POINT_BYTES),
              (entries - segs) * MADD_MULS * MONT_MUL_OPS, 20, warm_plain=False,
              segments=segs, planted_bucket_segments=hot_segs,
              window0_2pow16={"entries": w0[4], "segments": w0[5],
                              "planted_bucket_segments": w0_hot, "mismatches": w0_mism})
    k6["mismatches"] += w0_mism

    # K7: 2^20 lanes of Jacobian points with Z != 1 (p = P + Q of SRS
    # bases), partners rolled, then the planted lanes
    n = 1 << KERNEL_LOG2
    base = ec.jacobian_from_affine((ctx.table[:n, :8].contiguous(),
                                    ctx.table[:n, 8:].contiguous(),
                                    torch.zeros(n, dtype=torch.bool, device=DEVICE)))
    p = mk.padd(base, tuple(a.roll(1, 0).contiguous() for a in base))
    q = tuple(a.roll(7, 0).contiguous() for a in p)
    neg = ec.neg(p)
    q[0][:10], q[1][:10], q[2][:10] = p[0][:10], p[1][:10], p[2][:10]           # P + P
    q[0][10:20], q[1][10:20], q[2][10:20] = neg[0][10:20], neg[1][10:20], neg[2][10:20]
    for a in q:
        a[20:30] = 0                                                            # P + inf
    for a in p:
        a[30:50] = 0                                                            # inf + Q
    for a in q:
        a[40:50] = 0                                                            # inf + inf
    # products: 16 on a generic lane, 8 + 7 on P + P (8 before H, then
    # the doubling), 8 on P + (-P), none where an operand is infinity
    k7 = _row("K7 padd", lambda: mk.padd(p, q), lambda: mk.padd_plain(p, q), n,
              n * 3 * POINT_BYTES,
              ((n - 50) * ADD_MULS + 10 * (8 + DBL_MULS) + 10 * 8) * MONT_MUL_OPS, 20,
              warm_plain=False)

    # K7r: the first fold level over the uniform MSM's segment sums, then
    # every level of the fold of 2^20 0/1 scalars (2^19 entries, 2^14
    # segments in one bucket: a chain of 32 adds per thread at each level)
    sums = mk.bucket_sweep(ctx.table, idx, seg_start, seg_len)
    start, length, _ = ctx._groups(seg_bucket)
    groups = int((length > 0).sum())
    skew = _segments_of(ctx, FR.to_limbs_np([0, 1])[rng.integers(0, 2, ctx.n)])
    skew_sums = mk.bucket_sweep(ctx.table, *skew[:3])
    skew_mism = _fold_all_levels(ctx, skew_sums, skew[3])
    all_mism = _fold_all_levels(ctx, sums, seg_bucket)
    k7r = _row("K7r segment_fold", lambda: mk.segment_fold(sums, start, length),
               lambda: mk.segment_fold_plain(sums, start, length), segs,
               segs * POINT_BYTES + start.shape[0] * (16 + POINT_BYTES),
               (segs - groups) * ADD_MULS * MONT_MUL_OPS, 20, warm_plain=False,
               levels=ctx.fold_levels, groups=groups, group_width=ctx.group,
               all_levels_mismatches=all_mism,
               zero_one={"segments": skew[5], "hot_bucket_segments": int((skew[3] == 1).sum()),
                         "levels": ctx.fold_levels, "mismatches": skew_mism},
               note=f"level 1 of {ctx.fold_levels}; a thread is a chain of at most "
                    f"{ctx.group} dependent adds")
    k7r["mismatches"] += all_mism + skew_mism

    # K7w: the first level over the uniform MSM's 22 x 4096 bucket table,
    # then every level
    from plonkit_tpu_torch.gpu.msm import WINDOW_CHUNK
    table = ctx._bucket_table(sums, seg_bucket)
    rows_in = table[0].shape[0]
    chunks = rows_in // WINDOW_CHUNK
    finite = (table[2] != 0).any(dim=1).reshape(chunks, WINDOW_CHUNK)
    win_mism, win_levels = _window_all_levels(ctx, table)
    k7w = _row("K7w window_sums",
               lambda: sum(mk.window_sums(table, None, None, 1 << ctx.c, WINDOW_CHUNK)[:2], ()),
               lambda: sum(mk.window_sums_plain(table, None, None, 1 << ctx.c,
                                                WINDOW_CHUNK)[:2], ()),
               rows_in, (rows_in + 2 * chunks) * POINT_BYTES,
               _weighted_walk_ops(finite, WINDOW_CHUNK), 20, warm_plain=False,
               chunk=WINDOW_CHUNK, nonempty_buckets=int(finite.sum()),
               all_levels_mismatches=win_mism, levels=win_levels,
               note=f"level 1 of {win_levels}; a thread is a chain of {2 * WINDOW_CHUNK - 1} "
                    f"dependent adds and {WINDOW_CHUNK.bit_length() - 1} doublings: bound by "
                    "latency at the upper levels, not by the bytes or operations counted here")
    k7w["mismatches"] += win_mism

    # K8: one launch over the window totals of 11 MSMs (22 windows each,
    # c = 12: the vk's group), beside one single-MSM launch and the same 11
    # MSMs as 11 single-MSM launches in sequence
    batch = K8_BATCH
    w = tuple(a[n // 2:n // 2 + batch * ctx.num_windows].contiguous() for a in p)
    singles = [tuple(a[b * ctx.num_windows:(b + 1) * ctx.num_windows] for a in w)
               for b in range(batch)]
    one = singles[0]
    doublings = ctx.c * (ctx.num_windows - 1)
    k8 = _row("K8 combine", lambda: mk.combine(w, ctx.c, batch),
              lambda: mk.combine_plain(w, ctx.c, batch), batch * ctx.num_windows,
              batch * (ctx.num_windows + 1) * POINT_BYTES,
              batch * (doublings * DBL_MULS + (ctx.num_windows - 1) * ADD_MULS) * MONT_MUL_OPS,
              20, warm_plain=False, batch=batch, windows=ctx.num_windows,
              single_msm_ms=time_ms(lambda: mk.combine(one, ctx.c), 20),
              single_launches_ms=time_ms(lambda: [mk.combine(s, ctx.c) for s in singles], 5),
              note=f"{batch} MSMs, a thread each: ~{doublings + ctx.num_windows - 1} dependent "
                   "point operations a thread, bound by latency, not by the bytes or "
                   "operations counted here")
    return [k6, k7, k7r, k7w, k8]


def phase_kernels(ctx) -> list:
    t0 = time.perf_counter()
    rows = _field_rows() + _msm_rows(ctx)
    emit({"phase": "kernels", "seconds": round(time.perf_counter() - t0, 3),
          "mismatches": {r["name"]: r["mismatches"] for r in rows}})
    bad = [r["name"] for r in rows if r["mismatches"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return rows


def phase_msm(ctx, host_ctx) -> None:
    """The device MSM against the native host Pippenger at 2^20."""
    import torch
    from plonkit_tpu_torch.gpu import field_kernels as fk
    from plonkit_tpu_torch.gpu.mont import FR, to_tensor
    t0 = time.perf_counter()
    n = ctx.n
    rng = np.random.default_rng(SEED + 2)
    vectors = {
        "uniform": _random_fr_rows(rng, n, n // 2),
        "zero_one": FR.to_limbs_np([0, 1])[rng.integers(0, 2, n)],
        "constant": np.repeat(_random_fr_rows(rng, 1), n, axis=0),
        "single": np.zeros((n, 8), dtype=np.uint32),
    }
    vectors["single"][n // 3] = _random_fr_rows(rng, 1)[0]
    out, handles = {}, []
    for name, rows in vectors.items():
        rows = np.ascontiguousarray(rows)
        raw = to_tensor(rows, DEVICE)
        v = fk.mul(FR, raw, FR.const_raw(FR.r2_mod_p, n, DEVICE))     # Montgomery form
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = ctx.msm_vec(v)
        card_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        want = host_ctx.msm_rows(rows.view(np.uint8))
        host_ms = (time.perf_counter() - t) * 1e3
        out[name] = {"equal": got == want, "card_ms": card_ms, "host_ms": host_ms}
        handles.append((name, ctx.msm_vec_begin(v), want))
    batched = ctx.msm_vec_end_many([h for _, h, _ in handles])
    for (name, _, want), got in zip(handles, batched):
        out[name]["batched_equal"] = got == want
    emit({"phase": "msm", "points": n, "c": ctx.c, "windows": ctx.num_windows,
          "vectors": out, "seconds": round(time.perf_counter() - t0, 3)})
    bad = [k for k, v in out.items() if not (v["equal"] and v["batched_equal"])]
    if bad:
        raise AssertionError(f"device MSM differs from the native one: {bad}")


def _prove_bytes(circuit, key_path: str, device: str):
    from plonkit_tpu_torch.api import SetupForProver, verify
    from plonkit_tpu_torch.serialization import CrsHandle
    setup = SetupForProver(circuit, CrsHandle(key_path), device=device)
    vk = setup.make_verification_key()
    proof = setup.prove(circuit)
    if not verify(vk, proof):
        raise AssertionError(f"2^{CROSS_LOG2} proof on {device} does not verify")
    return vk.to_bytes(), proof.to_bytes()


def phase_cross_check(tmp: str) -> None:
    from plonkit_tpu_torch.api import gen_key_monomial_form
    from plonkit_tpu_torch.frontend.synthetic import synth_circuit
    t0 = time.perf_counter()
    key = os.path.join(tmp, f"srs_2pow{CROSS_LOG2}.key")
    gen_key_monomial_form(CROSS_LOG2).save(key)
    from plonkit_tpu_torch.gpu import msm_kernels as mk
    circuit = synth_circuit(CROSS_LOG2 - 1)
    _reset_launches()
    vk_gpu, proof_gpu = _prove_bytes(circuit, key, DEVICE)
    msm_launches = dict(mk.launches)
    vk_cpu, proof_cpu = _prove_bytes(circuit, key, "cpu")
    same = {"vk.bin": vk_gpu == vk_cpu, "proof.bin": proof_gpu == proof_cpu}
    emit({"phase": "cross_check", "domain": 1 << CROSS_LOG2, "identical": same,
          "card_msm_launches": msm_launches, "seconds": round(time.perf_counter() - t0, 3)})
    if not all(same.values()):
        raise AssertionError("cuda and cpu proves differ at 2^10")
    if not all(msm_launches.values()):
        raise AssertionError(f"2^10 commitments on the card missed an MSM kernel: {msm_launches}")


def _host_commit_backend():
    """A TorchBackend whose commitments all take the host Pippenger: the
    configuration of the port's first slice, for the byte comparison."""
    from plonkit_tpu_torch.backend import HostMSMContext
    from plonkit_tpu_torch.backend_torch import TorchBackend

    class HostCommitBackend(TorchBackend):
        def msm_context_from_crs(self, crs, size, key=None):
            return HostMSMContext.from_limbs(*crs.g1_limbs(size))

    return HostCommitBackend(DEVICE)


def _reset_launches() -> None:
    from plonkit_tpu_torch.gpu import field_kernels as fk, msm_kernels as mk, ntt
    for counts in (fk.launches, ntt.launches, mk.launches):
        for k in counts:
            counts[k] = 0


@contextlib.contextmanager
def _counting_commit_groups(groups: list):
    """Append the size of every group of device commitments TorchBackend
    is asked for (commit_many: its vectors; commit: 1) to `groups`."""
    from plonkit_tpu_torch.backend_torch import TorchBackend
    from plonkit_tpu_torch.gpu.msm import MSMContext
    many, one = TorchBackend.commit_many, TorchBackend.commit

    def commit_many(self, msm_ctx, vs):
        if isinstance(msm_ctx, MSMContext):
            groups.append(len(vs))
        return many(self, msm_ctx, vs)

    def commit(self, msm_ctx, v):
        if isinstance(msm_ctx, MSMContext):
            groups.append(1)
        return one(self, msm_ctx, v)

    TorchBackend.commit_many, TorchBackend.commit = commit_many, commit
    try:
        yield
    finally:
        TorchBackend.commit_many, TorchBackend.commit = many, one


def phase_main(key: str):
    from plonkit_tpu_torch import profiling
    from plonkit_tpu_torch.api import SetupForProver, verify
    from plonkit_tpu_torch.frontend.synthetic import synth_circuit
    from plonkit_tpu_torch.gpu import field_kernels as fk, msm_kernels as mk, ntt
    from plonkit_tpu_torch.serialization import CrsHandle, Proof
    t_all = time.perf_counter()
    times = {}

    t0 = time.perf_counter()
    circuit = synth_circuit(MAIN_LOG2 - 1)
    times["circuit"] = time.perf_counter() - t0

    _reset_launches()
    profiling.reset()
    groups = []
    with _counting_commit_groups(groups):
        t0 = time.perf_counter()
        setup = SetupForProver(circuit, CrsHandle(key), device=DEVICE)
        times["setup"] = time.perf_counter() - t0
        domain = setup.setup_polynomials.domain_size
        if domain != 1 << MAIN_LOG2:
            raise AssertionError(f"domain {domain}, expected 2^{MAIN_LOG2}")
        t0 = time.perf_counter()
        vk = setup.make_verification_key()
        times["vk"] = time.perf_counter() - t0
        msm_vk = profiling.last_timings.get("msm", 0.0)
        t0 = time.perf_counter()
        proof = setup.prove(circuit)
        times["prove"] = time.perf_counter() - t0
    launches = {"K1 mul": fk.launches["mul"], "K2a add": fk.launches["add"],
                "K2b sub": fk.launches["sub"], "K3 butterfly_dif": ntt.launches["butterfly_dif"],
                "K4 mul_add": fk.launches["mul_add"], "K5 butterfly": ntt.launches["butterfly"],
                "K6 bucket_sweep": mk.launches["bucket_sweep"], "K7 padd": mk.launches["padd"],
                "K7r segment_fold": mk.launches["segment_fold"],
                "K7w window_sums": mk.launches["window_sums"],
                "K8 combine": mk.launches["combine"]}
    commitments = mk.launches["bucket_sweep"]
    per_commitment = (mk.launches["segment_fold"] + mk.launches["window_sums"]
                      + mk.launches["padd"]) / max(1, commitments)
    stages = dict(profiling.last_timings)
    host_msm = stages.get("host msm", 0.0)

    t0 = time.perf_counter()
    ok = verify(vk, proof)
    tampered = Proof.read(io.BytesIO(proof.to_bytes()))
    tampered.wire_values_at_z[0] = (tampered.wire_values_at_z[0] + 1) % (1 << 253)
    rejected = not verify(vk, tampered)
    times["verify"] = time.perf_counter() - t0

    # the same setup, every commitment in the host Pippenger
    t0 = time.perf_counter()
    ref = copy.copy(setup)
    ref.backend, ref._prover_ctx = _host_commit_backend(), None
    same = {"vk.bin": ref.make_verification_key().to_bytes() == vk.to_bytes(),
            "proof.bin": ref.prove(circuit).to_bytes() == proof.to_bytes()}
    times["host_commit_reference"] = time.perf_counter() - t0

    emit({"phase": "main", "domain": domain, "msm": "device",
          "verified": ok, "tampered_rejected": rejected,
          "identical_to_host_commitments": same,
          "seconds": {k: round(v, 3) for k, v in times.items()},
          "stages_s": {k: round(v, 3) for k, v in stages.items()},
          "msm_s": {"vk": round(msm_vk, 3),
                    "prove": round(stages.get("msm", 0.0) - msm_vk, 3)},
          "host_msm_s": round(host_msm, 3),
          "launches": launches, "commit_groups": groups,
          "reduction_launches_per_commitment": per_commitment,
          "total_s": round(time.perf_counter() - t_all, 3)})
    if not ok or not rejected:
        raise AssertionError(f"verify: proof {ok}, tampered rejected {rejected}")
    if not all(same.values()):
        raise AssertionError(f"device and host commitments give other bytes: {same}")
    if host_msm:
        raise AssertionError("a commitment of the main path ran on the host")
    if per_commitment > REDUCTION_LAUNCHES_MAX:
        raise AssertionError(f"{per_commitment} reduction launches a commitment, "
                             f"more than {REDUCTION_LAUNCHES_MAX}")
    if sum(groups) != commitments or launches["K8 combine"] != len(groups):
        raise AssertionError(f"K8 launched {launches['K8 combine']} times and K6 "
                             f"{commitments} for the commitment groups {groups}: one K8 "
                             "launch a group expected")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    profile_prove(setup, circuit, vk)
    return launches, circuit, vk.to_bytes(), proof.to_bytes()


def _build_snapshot() -> dict:
    """name -> (size, mtime) of every built library, to show that no CLI
    process rebuilt one."""
    from plonkit_tpu_torch.gpu import build
    return {f: (st.st_size, st.st_mtime_ns) for f in sorted(os.listdir(build.BUILD_DIR))
            for st in [os.stat(os.path.join(build.BUILD_DIR, f))]}


def _same_file(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def phase_cli(tmp: str) -> None:
    """The base subcommands on the in-repo domain-64 circuit, on the card.
    Calls that do not need each other's files run at once."""
    t_all = time.perf_counter()
    d = os.path.join(tmp, "cli64")
    os.makedirs(d)
    circuit = os.path.join(FIXTURES, "circuit.r1cs.json")
    witness = os.path.join(FIXTURES, "witness_0.json")
    s = cli_together(("setup", ["setup", "-p", "10", "-m", "setup.key"]),
                     ("analyse", ["analyse", "-c", circuit, "-o", "analyse.json"]), cwd=d)
    s.update(cli_together(
        ("export-verification-key", ["export-verification-key", "-m", "setup.key",
                                     "-c", circuit, "-v", "vk.bin"]),
        ("prove", ["prove", "-m", "setup.key", "-c", circuit, "-w", witness]),
        ("dump-lagrange", ["dump-lagrange", "-m", "setup.key", "-l", "lagrange.key",
                           "-c", circuit]), cwd=d))
    with open(os.path.join(d, "proof.bin"), "rb") as f:
        blob = bytearray(f.read())
    blob[17] ^= 1                                   # a bit of the public input
    with open(os.path.join(d, "tampered.bin"), "wb") as f:
        f.write(blob)
    s.update(cli_together(
        ("prove -l", ["prove", "-m", "setup.key", "-l", "lagrange.key", "-c", circuit,
                      "-w", witness, "-p", "proof_l.bin", "-j", "proof_l.json",
                      "-i", "public_l.json"]),
        ("verify", ["verify", "-p", "proof.bin", "-v", "vk.bin"]),
        ("verify tampered", ["verify", "-p", "tampered.bin", "-v", "vk.bin"], 400 % 256),
        ("generate-verifier", ["generate-verifier", "-v", "vk.bin", "-s", "verifier.sol"]),
        cwd=d))
    with open(os.path.join(d, "analyse.json")) as f:
        stats = json.load(f)
    with open(os.path.join(d, "verifier.sol")) as f:
        sol = f.read()
    same = {"vk.bin = fixture vk.bin": _same_file(os.path.join(d, "vk.bin"),
                                                  os.path.join(FIXTURES, "vk.bin")),
            "prove -l = prove": _same_file(os.path.join(d, "proof_l.bin"),
                                           os.path.join(d, "proof.bin"))}
    emit({"phase": "cli", "domain": 64, "identical": same, "num_gates": stats["num_gates"],
          "contract_placeholders_left": sol.count("{{"),
          "seconds": {k: round(v, 3) for k, v in s.items()},
          "total_s": round(time.perf_counter() - t_all, 3)})
    if not all(same.values()) or "{{" in sol:
        raise AssertionError(f"CLI outputs differ: {same}, placeholders {sol.count('{{')}")


def phase_cli_full(tmp: str, key: str, circuit, vk_bytes: bytes, proof_bytes: bytes) -> None:
    """The main path's circuit through the CLI: its vk.bin and proof.bin
    must be the API's bytes.  export-verification-key and prove run at
    once (each transpiles the circuit on the host), then verify."""
    from plonkit_tpu_torch.frontend.r1cs import write_r1cs_bin
    from plonkit_tpu_torch.frontend.witness import write_witness_bin
    t_all = time.perf_counter()
    d = os.path.join(tmp, f"cli2pow{MAIN_LOG2}")
    os.makedirs(d)
    s = {}
    t0 = time.perf_counter()
    write_r1cs_bin(circuit.r1cs, os.path.join(d, "circuit.r1cs"))
    s["write .r1cs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_witness_bin(circuit.witness, os.path.join(d, "witness.wtns"))
    s["write .wtns"] = time.perf_counter() - t0
    s.update(cli_together(("export-verification-key", ["export-verification-key", "-m", key]),
                          ("prove", ["prove", "-m", key]), cwd=d))
    s["verify"] = cli("verify", cwd=d)
    with open(os.path.join(d, "vk.bin"), "rb") as f:
        vk_cli = f.read()
    with open(os.path.join(d, "proof.bin"), "rb") as f:
        proof_cli = f.read()
    same = {"vk.bin": vk_cli == vk_bytes, "proof.bin": proof_cli == proof_bytes}
    emit({"phase": "cli_full", "domain": 1 << MAIN_LOG2, "identical_to_api": same,
          "seconds": {k: round(v, 3) for k, v in s.items()},
          "total_s": round(time.perf_counter() - t_all, 3)})
    if not all(same.values()):
        raise AssertionError(f"CLI and API bytes differ at 2^{MAIN_LOG2}: {same}")


def merged_busy_us(intervals) -> float:
    """Total length of the union of [start, end) intervals (microseconds)."""
    busy, cur_start, cur_end = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy


def profile_prove(setup, circuit, vk) -> None:
    """A warm prove (prover context built by the first) under torch.profiler:
    device time by kernel name, the union of device activity, and the idle
    share of the prove's wall time."""
    import torch
    from plonkit_tpu_torch import profiling
    from plonkit_tpu_torch.api import verify
    profiling.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        proof = setup.prove(circuit)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not verify(vk, proof):
        raise AssertionError("the profiled proof does not verify")
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device activity")
    by_name = {}
    for e in kernels:
        rec = by_name.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.end - e.time_range.start
    busy = merged_busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:16]
    emit({"phase": "profile", "prove_wall_s": wall, "device_events": len(kernels),
          "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
          "msm_s": profiling.last_timings.get("msm", 0.0),
          "stages_s": {k: round(v, 3) for k, v in profiling.last_timings.items()},
          "by_kernel": [{"name": n[:80], "count": c, "ms": t / 1e3} for n, (c, t) in top]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import plonkit_tpu_torch  # noqa: F401  (fails outside the repository)
    from plonkit_tpu_torch.backend import HostMSMContext
    from plonkit_tpu_torch.backend_torch import TorchBackend
    from plonkit_tpu_torch.serialization import CrsHandle
    t0 = time.perf_counter()
    phase_build()
    with tempfile.TemporaryDirectory(prefix="plonkit_smoke_") as tmp:
        key = phase_srs(tmp)
        handle = CrsHandle(key)
        ctx = TorchBackend(DEVICE).device_msm_context(handle, 1 << MAIN_LOG2)
        rows = phase_kernels(ctx)
        phase_msm(ctx, HostMSMContext.from_limbs(*handle.g1_limbs(1 << MAIN_LOG2)))
        del ctx
        phase_cross_check(tmp)
        launches, circuit, vk_bytes, proof_bytes = phase_main(key)
        torch.cuda.empty_cache()
        built = _build_snapshot()
        with ThreadPoolExecutor(1) as pool:     # phases 7 and 8 at once
            full = pool.submit(phase_cli_full, tmp, key, circuit, vk_bytes, proof_bytes)
            phase_cli(tmp)
            full.result()
        if _build_snapshot() != built:
            raise AssertionError("a CLI process rebuilt a kernel library")
    for r in rows:
        r["launches"] = launches[r["name"]]
    emit({"kernels": rows})
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 3)})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
