#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (plonkit_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py          # from the root of the repository

Phases, each printing a JSON line with its wall seconds:

1. build: the CUDA kernels (csrc/*.cu, one nvcc per source, all at once) and
   the native host library (native/bn254.cpp), with each kernel's
   registers, shared memory, stack and spills from ptxas and the
   instructions of K1 (one Montgomery product), K6, K8, K9 and K10 from the
   CUDA toolkit's cuobjdump: K10's int8 warpgroup MMAs (IGMMA), TMA loads
   (UTMALDG) and mma.sync (IMMA), and K9's global stores by width; the
   phase fails unless K10 has IGMMA and UTMALDG and no IMMA, and every
   store of K9 is 16 bytes wide, and unless K12's and K13's kernels
   (csrc/scan.cu) build without a spill.  Then the card's name and power
   limit as nvidia-smi reports them;
2. srs: the tau = 42 dev SRS of 2^23 points, made on the card by the CLI's
   `setup -p 23` (gpu/fixed_base.py, in two parts of 2^22 points: 32 K7
   launches a part for the windowed ladder, K1 for the tau powers, the
   inversion of Z by K12 and K13), run in this process so that its
   launches can be counted (K7, K1, K12 and K13 must launch); the key's
   first 2^12 points must be byte-equal to srs.py's (serial python), the
   sha256 of its first 2^22 points that of the 2^22 key `setup -p 22`
   made (the in-repo scratch/recursive_r22/srs_2pow22.key's), and its G2
   pair [G2, 42 G2].  The 2^20, 2^21 and 2^22 phases read prefixes of this
   key;
3. kernels: every kernel on the card against its plain PyTorch version on
   the card, on the same inputs, equal bit for bit (integer arithmetic):
   K1 mul, K2a add, K2b sub, K4 mul_add at 2^20 elements and K3
   butterfly_dif, K5 butterfly on 2^19 butterflies (random Montgomery Fr
   values from a fixed numpy seed, with 0, 1, p-1 and p-2 planted; K3 and
   K5 with a real stage's twiddles, K5 reading the even and odd rows of one
   buffer as the inverse transform does, and again as a batched stage of
   the 4-step NTT: 2^10 transforms of 2^10 points, gpu/ntt.ntt_batched's
   [m, B] layout); K6 bucket_sweep on the
   segments of one MSM of 2^20 random scalars over the SRS bases (the main
   path's shape) and on the sorted window-0 entries of 2^16 of them, both
   with a planted bucket of more than four segments; K7 padd at 2^20 lanes with
   planted P + P, P + (-P), P + inf, inf + Q and inf + inf lanes; K7r
   segment_fold on the first fold level of that MSM's segment sums (timed),
   and on every level of the fold of 2^20 0/1 scalars (~2^19 entries in
   one bucket); K7w window_sums on the first level of that MSM's 22 x 4096
   bucket table (timed), and on every level; K8 combine in one launch over
   the 22 random Jacobian window totals (c = 12) of each of 11 MSMs; K9
   balanced_digits, K10 dft_product and K11 fold_redc (the tensor-core NTT,
   gpu/ntt_mxu.py) at the radix-128 level of a 2^20-point transform (8192
   columns), K10 timed beside torch._int_mm on the same operands (the
   yardstick; the port never calls it) and also held at the radix-256
   level of 2^22 points (the 71 MB table), at radix 16 (depth padded from
   528 to 544), on a 16 x 8 x 32 product and at every radix 2-256 with N =
   1 and N = 37 (ragged tiles); K9 also at r = 1 with the 256^2 * 33
   columns of the radix-256 table build and at ragged batches; K12
   field_scan at the main path's shapes (the grand product's Fr exclusive
   prefix product at 2^20, timed; divide_by_linear's Fr exclusive suffix
   sum at 2^20; an SRS part's Fq prefix product at 2^22) and in every form
   over both fields at ragged n (1 to 3 tiles and a few rows), zeros at the
   first and last rows; K13 field_inverse on the total of a 2^20 product
   (with its steps) and on edge and random rows; and
   field_kernels.batch_inverse (two K12 launches and one K13) at 2^20: its
   time, launches, bound and mismatches against batch_inverse_plain (also
   at ragged n with zeros at the first row, the last, every third and
   everywhere, Fr and Fq), x * x^-1 = 1, and no device-to-host copy in
   torch.profiler's record of one batch_inverse and one grand_product
   call; K14 g1_butterfly and K15 g1_scale (the group NTT,
   gpu/group_ntt.py) at the main path's shapes, on SRS points summed in
   pairs (Z != 1): K14 on stage 0 of a 2^20-point inverse transform (2^19
   butterflies, w = 1 in lane 0; lo, hi or both at infinity, lo = [w]hi
   and lo = -[w]hi planted in lanes the check reads), K15 by 1/2^20 on the
   2^20 points; the output of the launch kept is held against the plain
   version on every 128th (K14) or 256th (K15) lane, 2^12 lanes each, the
   planted ones among them.  Times are CUDA events after a sleep kernel
   that holds the card while the host queues the calls;
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
   points a user calls, commitments on the card ("msm": "device"), under
   PLONKIT_TPU_NTT's default, auto (the tensor cores for every transform
   of 512 points or more), with the launch count of every kernel read from
   setup, vk and the first prove alone (each must launch, K3/K5 excepted);
   then a warm prove under auto and one under pease, the butterflies, each
   with its own launch counts (K3 and K5 must launch in the pease one),
   whose proof.bin must be the first proof's bytes; and the launches
   of the bucket reduction (K7r, K7w, K7) per commitment, at most 8, and
   one K8 launch for each group of commitments the backend was asked for
   (a commit_many call, or a single commit).  The proof must verify and a
   tampered copy must not.  Then the synthetic chain at a 2^16 domain
   (REFERENCE_LOG2: below the main domain, since the host Pippenger's
   22 commitments would take most of a minute at 2^20)
   makes vk.bin and proof.bin with commitments on the card, and the same
   setup makes them again with every commitment in the host Pippenger (a
   TorchBackend subclass defined here): the bytes must be identical.  A
   last prove on the 2^20 device setup runs under torch.profiler: device time by
   kernel, and the device's busy time and idle share over its wall time.
   Then the Lagrange form of the 2^23 key at the main domain, made on the
   card by api.crs_lagrange_form under torch.profiler (wall and device
   seconds; 20 K14 launches, one K15, and K12, K13 and K1, which must
   launch), written as a key file (its sha256 for phase 8), and one prove
   with it from a copy of the setup: its proof.bin must be the first
   proof's;
7. cli: `python3 -m plonkit_tpu_torch` in subprocesses, on the card, on the
   in-repo circuit scratch/recursive_r22 (domain 64): setup -p 10 (on the
   card: its points must be the first 2^10 of phase 2's key), analyse,
   export-verification-key (its vk.bin must equal the fixture's, made by the
   JAX package), prove (keccak), dump-lagrange (the card's lagrange.key must
   equal `--backend cpu dump-lagrange`'s) and prove -l (the same
   proof.bin), verify (exit 0) and a tampered proof (exit 144),
   generate-verifier (no placeholder left), prove -t rescue of
   scratch/recursive_r5/witness_0.json (equal to that fixture's proof_0.bin)
   and verify -t rescue (exit 0).  The inner proofs of phase 10 past the
   fixture's pair: scripts/gen_inner_circuit.py writes the circuit (equal
   to the fixture's file) and witness_2.json ... witness_4.json; prove -t
   rescue of each on the card (the first wave after setup, since phase 10
   waits for them) and with --backend cpu must give the same
   proof_<i>.bin, and verify -t rescue must accept the card's.  The calls
   that use no card (those CPU proves and the CPU dump-lagrange, over the
   first points of phase 2's key) start as soon as that key exists and
   run beside phases 3-6, out of the wave of phases 7-10;
8. cli at full width: the main path's circuit written as .r1cs and .wtns,
   then export-verification-key, prove and dump-lagrange at once, then
   prove -l and verify through the CLI: vk.bin, proof.bin and prove -l's
   proof.bin must equal the main phase's bytes from the API, lagrange.key
   the sha256 of phase 6's key.  No CLI process may rebuild a kernel
   library;
9. recursive CLI on scratch/recursive_r5 (one rescue proof of the domain-64
   circuit; the JAX package's aggregate at 2^21): the 5 recursive
   subcommands, each once, over the key:
   export-recursive-verification-key and recursive-prove at once (each
   synthesises the 1,611,923-gate aggregation circuit), then
   recursive-verify (exit 0), recursive-verify of a copy with one flipped
   byte (exit 144), check-aggregation (exit 0) and
   generate-recursive-verifier -i 2; recursive_vk.bin, recursive_proof.bin
   and recursive_verifier.sol must equal the fixture's byte for byte.
   Beside them, export-recursive-verification-key -c 2 -i 2 of the
   two-proof circuit of scratch/recursive_r22 (2,307,899 gates, a 2^22
   domain): its recursive_vk.bin must equal that fixture's, made by the
   JAX package; and export-recursive-verification-key -c 5 -i 2 (4,395,827
   gates, a 2^23 domain), the vk of phase 10's aggregate, which no package
   had made before (phase 10 verifies with it).  Phases 7, 8, 9 and 10
   run at the same time, and so do the calls of each that need no file
   of another: their seconds are wall times of processes that share the
   host and the card;
10. recursive path in this process, five proofs at a 2^23 domain, started
   as soon as phase 7 has proved the inner proofs, beside the CLI
   processes of phases 7-9 (its host stage times are taken under their
   contention): prove_aggregation of scratch/recursive_r22/proof_{0,1}.bin
   (the JAX package's) and phase 7's proof_2.bin ... proof_4.bin under
   torch.profiler, with its gate count (4,395,827, from the port's log
   line), every kernel's launches counted from 0 (each must launch, the
   butterflies excepted), its stage times (the prover rounds x r1 ... x
   r5), torch.cuda.max_memory_allocated() and the stage whose end first
   saw it, the peak host RSS of this process (and phase 9's of its `-c 5`
   export), the device's busy time and idle share, and the
   transforms by size: every 2^25-point coset LDE and iNTT must take the
   split path (backend_torch.SPLIT_NTT_MIN), at least one of each, and no
   engine may run 2^25 points whole.  Once phase 9's five-proof vk is
   there, verify_aggregation with it must accept the aggregate and
   reject a copy with one flipped byte of the outer public input, and
   check_aggregation must accept it.  The aggregate is written as
   recursive_proof.bin: the CLI's recursive-verify must exit 0 on it and
   144 on the flipped copy, and check-aggregation with the five-line
   proof list 0.  Then the device ms of one commitment at 2^22 and at
   2^23 points, and the split coset transforms at their threshold
   (backend_torch.SPLIT_NTT_MIN = 2^24, the LDE of a 2^22 domain): the
   2^24-point coset LDE of one 2^22-point vector, its coset iNTT and the
   2^24-point coset NTT of that LDE, split and monolithic (the threshold
   raised in this process), equal bit for bit, and the iNTT giving the
   vector back, under each NTT engine (auto and pease), the two engines'
   results equal too;
11. contract: the rendered verifiers run in the port's interpreter
   (solvm.py, through contract.py) on the card's proofs: phase 7's
   verifier.sol on its keccak proof.json / public.json, phase 9's
   recursive_verifier.sol on its recursive_proof.json, and the recursive
   verifier of phase 9's five-proof vk, rendered for all ten inputs of
   the five proofs, on phase 10's aggregate; each must accept the proof
   and reject every tampered copy.  The same verifier rendered for one
   proof's two inputs, as generate-recursive-verifier -i 2 renders it,
   must revert "bad input count" on the aggregate;
12. poseidon (phases 12-14 run after phase 10's split check and before
   phase 11, so that phases 1-11 measure as before): the Poseidon hash
   chain of scripts/bench_prove.py (poseidon_chain_circuit(20):
   454 circomlib Poseidon(2) hashes, ~1,047,379 gates, a 2^20 domain):
   SetupForProver, make_verification_key, prove (then a warm prove) and
   verify on the card, a tampered copy rejected, with the host build,
   setup, vk and prove seconds and the prover's stages.  Then a foreign
   SRS: a seeded random tau, 2^20 points made on the card
   (gpu/fixed_base.gen_crs_g1_device), written with save_crs_g1_limbs and
   read back through CrsHandle; the same setup's host work, copied with
   that key and no prover context, proves and verifies, and the proof
   fails against the tau = 42 vk;
13. mesh: the same Poseidon setup with its backend swapped to
   parallel/backend_mesh.MeshBackend over a one-rank NCCL world in this
   process (NCCL takes one rank per card, and the smoke needs one card):
   its vk.bin and proof.bin must be
   phase 12's bytes; the launches of every kernel on this path (each must
   launch, K2b excepted if the path takes no sub), every commitment
   through parallel/msm.DistributedMSMContext, the counts of distributed
   and gathered operations and the collectives' calls and bytes.  Phase
   7 also runs `--backend mesh prove` on the domain-64 fixture in its
   pool: its proof.bin must equal `prove`'s;
14. mesh_ranks: parallel/dryrun.dryrun_multichip(4,
   "cuda", "gloo"), four spawned ranks sharing the card over gloo: the
   domain-64 fixture proved on the mesh gives scratch/recursive_r22's
   vk.bin and proof_0.bin; the distributed MSM over 2^16 points equals the
   host Pippenger; the distributed NTT and iNTT at 2^20 equal gpu/ntt's
   bit for bit; the synthetic chain at 2^16 (n1 = n2 = 2^8) proved on the
   mesh, every commitment through DistributedMSMContext, gives the
   single-device vk.bin and proof.bin.  The ranks load the libraries
   phase 1 built: none is rebuilt;
15. ntt_engines (after phase 10's split check, before phase 12): both NTT
   engines on the same random vectors, the butterflies (gpu/ntt.py, K3/K5)
   and the tensor cores (gpu/ntt_mxu.py, K9-K11): ntt and intt at 2^20,
   the coset LDE x4 of a 2^20 vector, coset_ntt and coset_intt at 2^22 and
   a monolithic 2^24 coset_ntt, and ntt at 2^9 to 2^18 (where auto's
   threshold lies), equal bit for bit, each inverse giving its vector
   back; each engine's device ms and launches per transform, and the
   sizes at which the tensor cores take less time.

Every phase after phase 1 runs under PLONKIT_TPU_NTT's default, auto, so
on the card the tensor-core engine carries every transform of 512 points
or more, and every byte check above holds it.

Then the kernels line (each row with its launches on the main path of
phase 6, in phase 6's pease prove, on the recursive path of phase 10, in
the device SRS of phase 2, on the mesh path of phase 13 and in phase 6's
Lagrange dump), the card line, and as the last line
{"ok": true, "device": {...}}.  Any failure raises: the exit code is not 0
and no result line is printed.  Without a CUDA device it stops at once.
"""

import contextlib
import copy
import hashlib
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
MAIN_LOG2 = 20          # phase 6 domain
REFERENCE_LOG2 = 16     # phase 6's prove with host commitments
ONE_PROOF_LOG2 = 21     # the aggregation circuit of one proof (phase 9)
PAIR_LOG2 = 22          # the aggregation circuit of two proofs (phase 9)
AGG_PROOFS = 5          # the recursive workload of phase 10: the first count at 2^23
AGG_GATES = 4_395_827   # its aggregation circuit
AGG_LOG2 = 23           # its domain
INNER = range(2, AGG_PROOFS)    # gen_inner_circuit.py's witnesses past the fixture's pair
SRS_LOG2 = AGG_LOG2     # the device SRS
SPLIT_FACTOR = 4        # the prover's LDE factor: 2^24-point transforms at 2^22
SRS_CHECK_LOG2 = 12     # key prefix held against srs.py byte for byte
# sha256 of the first 2^22 points of the tau = 42 key (the G1 section of a
# 2^22 key, its header left out): the points of the key `setup -p 22` makes
# and of scratch/recursive_r22/srs_2pow22.key (tests/test_torch_fixed_base.py)
SRS_PREFIX_LOG2 = 22
SRS_PREFIX_SHA256 = "cc86d1ad413d102e53fb45a7c48de3da075d43ba11079c98bb0bd4e8661eff2b"
POSEIDON_LOG2 = 20      # the Poseidon chain's domain (phases 12, 13)
POSEIDON_HASHES = 454   # its chain length (scratch/bench_poseidon_2pow20.log)
MESH_RANKS = 4          # gloo ranks sharing the card (phase 14)
SWEEP_NTT_LOG2 = (9, 12, 14, 16, 18)    # phase 15's ntt sizes below the main one
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth,
# and 32-bit integer multiplies: 64 lanes per SM per clock on sm_90, half
# the 128 FP32 lanes behind the 67 TFLOP/s float32 figure (2 flops per
# FMA), so 67e12 / 4.
HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 67e12 / 4
PRE_ROLL_CYCLES = 20_000_000               # ~10 ms of sleep kernel ahead of a timing

# 32-bit multiply instructions of one Montgomery product: 64 + 64 wide
# products of 2 instructions each, plus 8 for m = t0 * n0
MONT_MUL_OPS = 2 * (64 + 64) + 8
POINT_BYTES = 3 * 32                       # a Jacobian point, [3, 8] words
MADD_MULS, ADD_MULS, DBL_MULS = 11, 16, 7  # products of madd, add, double
REDUCTION_LAUNCHES_MAX = 8                 # K7r + K7w + K7 per commitment
K8_BATCH = 11                              # MSMs of the K8 row: the vk's group
REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "scratch", "recursive_r22")   # domain-64 circuit, its pair
AGG_FIXTURES = os.path.join(REPO, "scratch", "recursive_r5")  # the 2^21 aggregate of phase 9
INT8_OPS_PER_S = 1979e12   # dense int8 tensor-core operations (2 a multiply-add)
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
    # XLA in tpu/ntt_mxu.py, not Pallas: _to_balanced, the dot_general of
    # _dft_base, _fold_redc
    "K9 balanced_digits": ("plonkit_tpu_torch/csrc/ntt_mxu.cu",
                           "plonkit_tpu/tpu/ntt_mxu.py:156"),
    "K10 dft_product": ("plonkit_tpu_torch/csrc/ntt_mxu.cu", "plonkit_tpu/tpu/ntt_mxu.py:212"),
    "K11 fold_redc": ("plonkit_tpu_torch/csrc/ntt_mxu.cu", "plonkit_tpu/tpu/ntt_mxu.py:172"),
    # the Hillis-Steele scans over pk.mul / pk.add (backend_jax.py:145
    # prefix products, :167 suffix products, :314 suffix sums, and those of
    # pallas_kernels.py:173 batch_inverse); the Fermat inverse of the total
    "K12 field_scan": ("plonkit_tpu_torch/csrc/scan.cu", "plonkit_tpu/backend_jax.py:145"),
    "K13 field_inverse": ("plonkit_tpu_torch/csrc/scan.cu", "plonkit_tpu/tpu/mont.py:298"),
    # no TPU kernel: the JAX package's host python group NTT (its
    # butterflies' g1_mul, then g1_mul by 1/n)
    "K14 g1_butterfly": ("plonkit_tpu_torch/csrc/group_ntt.cu", "plonkit_tpu/api.py:99"),
    "K15 g1_scale": ("plonkit_tpu_torch/csrc/group_ntt.cu", "plonkit_tpu/api.py:95"),
}
SCAN_KERNELS = ("field_scan_mul_kernel", "field_scan_add_kernel", "field_inverse_kernel")
BUTTERFLIES = ("K3 butterfly_dif", "K5 butterfly")
TENSOR_CORE_NTT = ("K9 balanced_digits", "K10 dft_product", "K11 fold_redc")
GROUP_NTT = ("K14 g1_butterfly", "K15 g1_scale")     # the Lagrange form of a key alone


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
    after one warm-up call).  A sleep kernel ahead of the start event holds
    the card while the host queues the calls, so the host's launch overhead
    does not count where it exceeds a call's device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(PRE_ROLL_CYCLES)
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
    mxu = sass_counts(build.library_path("ntt_mxu"), {"dft_product_kernel",
                                                      "balanced_digits_kernel"})
    emit({"build": "sass", "field": sass_counts(build.library_path("field"), {"mul_kernel"}),
          "msm": sass_counts(build.library_path("msm"), {"bucket_sweep_kernel",
                                                         "combine_kernel"}),
          "ntt_mxu": mxu})
    if "scan" in log:                   # built by this process (a fresh checkout)
        scan = ptxas_by_kernel(log["scan"]["ptxas"])
        if set(SCAN_KERNELS) - set(scan) or any(scan[k]["spill_bytes"] for k in SCAN_KERNELS):
            raise AssertionError(f"K12/K13 ptxas: {scan}: a kernel is missing or spills")
    k10, k9 = mxu["dft_product_kernel"], mxu["balanced_digits_kernel"]
    if not k10["igmma"] or not k10["utmaldg"] or k10["imma"]:
        raise AssertionError(f"K10 is not on wgmma fed by TMA: {k10}")
    if not k9["stg_16_bytes"] or k9["stg_narrower"]:
        raise AssertionError(f"K9 stores narrower than 16 bytes: {k9}")
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
    -sass): in all, of the IMAD family, int8 warpgroup MMAs (IGMMA),
    mma.sync on integers (IMMA), TMA loads (UTMALDG), and global stores 16
    bytes wide and narrower."""
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
        stores = [op for op in ops if op.startswith("STG")]
        out[short.group(1)] = {"instructions": len(ops),
                               "imad": sum(op.startswith("IMAD") for op in ops),
                               "igmma": sum(op.startswith("IGMMA") for op in ops),
                               "imma": sum(op.startswith("IMMA") for op in ops),
                               "utmaldg": sum(op.startswith("UTMALDG") for op in ops),
                               "stg_16_bytes": sum(op.endswith(".128") for op in stores),
                               "stg_narrower": sum(not op.endswith(".128") for op in stores)}
    if set(out) != set(kernels):
        raise AssertionError(f"cuobjdump -sass {lib}: found {sorted(out)} of {sorted(kernels)}")
    return out


def cli(*args, cwd: str, expect: int = 0, peak_rss: list = None, threads: int = None) -> float:
    """`python3 -m plonkit_tpu_torch *args` in a subprocess (the default
    backend, the card); raises unless it exits with `expect`.  Returns its
    wall seconds.  `threads` caps the process's CPU threads (OpenMP and
    PyTorch's intra-op pool).  With `peak_rss`, sets peak_rss[0] to the largest
    resident bytes of the process read from /proc/<pid>/statm every half
    second until it exits (resource's RUSAGE_CHILDREN counts this process's
    RSS at the fork, and not every kernel's /proc has VmHWM)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "plonkit_tpu_torch", *args], cwd=cwd,
                            env=dict(os.environ, PYTHONPATH=REPO,
                                     **({"OMP_NUM_THREADS": str(threads),
                                         "MKL_NUM_THREADS": str(threads)} if threads else {})),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    while True:
        try:
            _, err = proc.communicate(timeout=0.5 if peak_rss is not None else 600)
            break
        except subprocess.TimeoutExpired:
            if peak_rss is None or time.perf_counter() - t0 > 600:
                proc.kill()
                proc.communicate()
                raise
            with contextlib.suppress(OSError), open(f"/proc/{proc.pid}/statm") as f:
                pages = int(f.read().split()[1])
                peak_rss[0] = max(peak_rss[0], pages * os.sysconf("SC_PAGE_SIZE"))
    if proc.returncode != expect:
        raise AssertionError(f"plonkit_tpu_torch {' '.join(args)} exited {proc.returncode}, "
                             f"expected {expect}:\n{err[-4000:]}")
    return time.perf_counter() - t0


def cli_together(*calls, cwd: str) -> dict:
    """Several CLI processes at once, each (label, args) or (label, args,
    expect); returns {label: wall seconds}, raising if any call failed."""
    with ThreadPoolExecutor(len(calls)) as pool:
        futures = {c[0]: pool.submit(cli, *c[1], cwd=cwd, expect=c[2] if len(c) > 2 else 0)
                   for c in calls}
        return {label: f.result() for label, f in futures.items()}


def phase_srs(tmp: str) -> str:
    """`setup -p 23` through the CLI's entry point, in this process."""
    import torch
    from plonkit_tpu_torch import cli as port_cli
    from plonkit_tpu_torch.curve import G2_GEN, g2_mul
    from plonkit_tpu_torch.serialization import CrsHandle, write_g1
    from plonkit_tpu_torch.srs import dev_srs_g1
    key = os.path.join(tmp, f"srs_2pow{SRS_LOG2}.key")
    _reset_launches()
    t0 = time.perf_counter()
    port_cli.main(["setup", "-p", str(SRS_LOG2), "-m", key])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    t0 = time.perf_counter()
    n = 1 << SRS_CHECK_LOG2
    want = io.BytesIO()
    for p in dev_srs_g1(n, 42):
        write_g1(want, p)
    with open(key, "rb") as f:
        f.seek(8)
        prefix = f.read(64 << SRS_PREFIX_LOG2)
    handle = CrsHandle(key)
    same = {"g1_prefix": prefix[:64 * n] == want.getvalue(),
            f"sha256 of the 2^{SRS_PREFIX_LOG2} prefix":
                hashlib.sha256(prefix).hexdigest() == SRS_PREFIX_SHA256,
            "count": handle.num_g1 == 1 << SRS_LOG2,
            "g2": handle.g2_monomial_bases == [G2_GEN, g2_mul(G2_GEN, 42)]}
    del prefix
    emit({"phase": "srs", "points": 1 << SRS_LOG2, "route": "device (gpu/fixed_base.py)",
          "seconds": round(seconds, 3), "launches": launches,
          "identical_to_srs_py": same, "compared_points": n,
          "serial_srs_py_s_for_compared_points": round(time.perf_counter() - t0, 3)})
    if not all(same.values()):
        raise AssertionError(f"device SRS differs from srs.py: {same}")
    idle = [k for k in ("K7 padd", "K1 mul", "K12 field_scan", "K13 field_inverse")
            if not launches[k]]
    if idle:
        raise AssertionError(f"the device SRS missed {idle}: {launches}")
    return key, launches


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


def _row(name, kern, plain, count, bytes_moved, int32_muls, reps, warm_plain=True,
         int8_ops=0, library=None, **extra):
    """Run kernel and plain version, compare them, time both (the kernel
    over `reps` launches after a warm-up, the plain version on the call
    compared, after a warm-up call unless warm_plain is False), and reckon
    the bound from this input's bytes, 32-bit multiplies and int8
    tensor-core operations.  `library`, one PyTorch call computing the same
    function, is timed like the kernel."""
    import torch
    got = kern()
    if warm_plain:
        plain()
    want, plain_ms = _timed_once(plain)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    return _row_of(name, count, time_ms(kern, reps), plain_ms, _mismatches(got, want),
                   _max_abs_err(got, want), bytes_moved, int32_muls, int8_ops,
                   time_ms(library, reps) if library else None, **extra)


def _max_abs_err(got, want) -> int:
    """The largest difference of two limbs read as uint32."""
    import torch
    return max(int(((g.to(torch.int64) & 0xFFFFFFFF) - (w.to(torch.int64) & 0xFFFFFFFF))
                   .abs().max()) for g, w in zip(got, want))


def _row_of(name, count, ms, plain_ms, mism, err, bytes_moved, int32_muls, int8_ops=0,
            library_ms=None, **extra) -> dict:
    """A kernels-line row: the measured times, the comparison, and the bound
    reckoned from this input's bytes, 32-bit multiplies and int8 operations."""
    bytes_s = bytes_moved / HBM_BYTES_PER_S
    ops_s = max(int32_muls / INT32_MUL_PER_S, int8_ops / INT8_OPS_PER_S)
    source, replaces = SOURCES[name]
    return dict({
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "elements": count, "mismatches": mism, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_s, ops_s) * 1e3,
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "bound_bytes": bytes_moved, "bound_int32_muls": int32_muls, "bound_int8_ops": int8_ops,
        "bound_basis": "max(bytes / 3.35e12 B/s, int32 multiplies / 16.75e12 per s, "
                       "int8 operations / 1.979e15 per s)",
        "library_ms": library_ms,
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
    # K5 on stage 1 of the batched inverse transforms of the 4-step NTT
    # (gpu/ntt.ntt_batched): m = 2^10 points in each of B = 2^10 columns,
    # transform axis outermost, so the even and odd rows are blocks of B
    # rows 2B apart
    m = bsz = 1 << (KERNEL_LOG2 // 2)
    pairs = b.view(m // 2, 2 * bsz, 8)
    blo, bhi = pairs[:, :bsz], pairs[:, bsz:]
    tw_b = ntt._stage_twiddles(ntt.powers(fr_inv(get_domain_omega(m)), m // 2, DEVICE), 1,
                               m // 2, bsz)
    out_b = torch.empty_like(b)

    def plain_bfly():
        return mont.add(FR, lo, hi), mont.mont_mul(FR, tw, mont.sub(FR, lo, hi))

    def batched_k5():
        got = ntt.butterfly(FR, blo, bhi, tw_b, out_b)
        want = mont.butterfly(FR, blo.reshape(-1, 8), bhi.reshape(-1, 8), tw_b)
        return {"shape": [m, bsz], "mismatches": _mismatches(got, want),
                "ms": time_ms(lambda: ntt.butterfly(FR, blo, bhi, tw_b, out_b), 20)}

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
             5 * 32 * half, MONT_MUL_OPS * half, 20, batched=batched_k5()),
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


def _ntt_mxu_rows() -> list:
    """K9, K10 and K11 on the card against their plain versions on the
    card, at the radix-128 level of a 2^20-point transform: 2^20 random
    canonical rows as [128, 8192, 8], the forward table, and the level's
    digits and product.  K10 also at the radix-256 level of 2^22 points,
    at radix 16 (the padded depth), on a 16 x 8 x 32 product and at every
    radix with N = 1 and N = 37; K9 also at r = 1 with the columns of the
    radix-256 table build and at ragged batches."""
    import torch
    from plonkit_tpu_torch.gpu import ntt_mxu as gmxu
    from plonkit_tpu_torch.gpu.mont import to_tensor
    rng = np.random.default_rng(SEED + 4)

    def level(r, batch):
        planted = 0 if r * batch >= 4 else None
        x = to_tensor(_random_fr_rows(rng, r * batch, planted), DEVICE).view(r, batch, 8)
        table = gmxu._dft_table(r, False, DEVICE)
        digits = gmxu.balanced_digits(x)
        return x, table, digits, gmxu.dft_product(table, digits)

    def product_mismatches(table, digits):
        return _mismatches((gmxu.dft_product(table, digits),),
                           (gmxu.dft_product_plain(table, digits),))

    r, batch = 128, (1 << MAIN_LOG2) // 128
    x, table, digits, g = level(r, batch)
    n, m, kp = r * batch, table.shape[0], table.shape[1]
    k9_checks = {}
    for label, (rr, bb) in {"r = 1, the radix-256 table build": (1, 256 * 256 * gmxu.NB),
                            "radix 256, 37 columns": (256, 37),
                            "radix 64, 3 columns": (64, 3)}.items():
        xx = to_tensor(_random_fr_rows(rng, rr * bb, 0), DEVICE).view(rr, bb, 8)
        k9_checks[label] = {"shape": [rr, bb], "mismatches": _mismatches(
            (gmxu.balanced_digits(xx),), (gmxu.balanced_digits_plain(xx),))}
        del xx
    k9 = _row("K9 balanced_digits", lambda: gmxu.balanced_digits(x),
              lambda: gmxu.balanced_digits_plain(x), n, 32 * n + batch * kp, 0, 20,
              radix=r, columns=batch, checks=k9_checks)
    k9["mismatches"] += sum(c["mismatches"] for c in k9_checks.values())
    lib_mism = _mismatches((torch._int_mm(table, digits.t()),), (g,))
    checks = {}
    for label, (rr, bb) in {f"radix 256, 2^{PAIR_LOG2} points": (256, (1 << PAIR_LOG2) // 256),
                            "radix 16, 512 points (depth 528 -> 544)": (16, 32)}.items():
        _, t, d, _ = level(rr, bb)
        checks[label] = {"shape": [t.shape[0], bb, t.shape[1]],
                         "mismatches": product_mismatches(t, d)}
        del t, d
    for rr in (2, 4, 8, 16, 32, 64, 128, 256):
        for bb in (1, 37):
            _, t, d, _ = level(rr, bb)
            checks[f"radix {rr}, N = {bb}"] = {"shape": [t.shape[0], bb, t.shape[1]],
                                               "mismatches": product_mismatches(t, d)}
    gen = torch.Generator().manual_seed(SEED)
    tile_a = torch.randint(-128, 128, (16, 32), generator=gen, dtype=torch.int8).to(DEVICE)
    tile_x = torch.randint(-128, 128, (8, 32), generator=gen, dtype=torch.int8).to(DEVICE)
    checks["16 x 8 x 32"] = {"shape": [16, 8, 32],
                             "mismatches": product_mismatches(tile_a, tile_x)}
    k10 = _row("K10 dft_product", lambda: gmxu.dft_product(table, digits),
               lambda: gmxu.dft_product_plain(table, digits), m * batch,
               m * kp + batch * kp + 4 * m * batch, 0, 20, warm_plain=False,
               int8_ops=2 * m * batch * (r * gmxu.NB),
               library=lambda: torch._int_mm(table, digits.t()),
               library_call="torch._int_mm(A, X.T)", library_mismatches=lib_mism,
               shape=[m, batch, kp], checks=checks)
    k10["mismatches"] += lib_mism + sum(c["mismatches"] for c in checks.values())
    # REDC: one 32-bit step (1 + 16 multiply instructions) and one 16-bit step
    k11 = _row("K11 fold_redc", lambda: gmxu.fold_redc(g).view(-1, 8),
               lambda: gmxu.fold_redc_plain(g).view(-1, 8), n, 4 * gmxu.NB * n + 32 * n,
               34 * n, 20, radix=r, columns=batch)
    return [k9, k10, k11]


SCAN_RAGGED = (1, 2, 3, 4095, 4096, 4097, 3 * 4096 + 5)   # K12 tiles are 4096 rows
ZERO_PATTERNS = ("first", "last", "thirds", "all")


def _planted_zeros(rows: np.ndarray, pattern: str) -> np.ndarray:
    """A copy of the rows with zeros at the first row, the last row, every
    third row or everywhere."""
    rows = rows.copy()
    rows[{"first": slice(0, 1), "last": slice(-1, None), "thirds": slice(None, None, 3),
          "all": slice(None)}[pattern]] = 0
    return rows


def _scan_rows() -> list:
    """K12 and K13 on the card against their plain versions on the card.
    K12 at the main path's shapes: the grand product (the Fr exclusive
    prefix product at 2^20: the row's own numbers), divide_by_linear's
    exclusive suffix sums (Fr, 2^20) and an SRS part's Fq prefix product
    (2^22 rows, the 128 MB vectors; its plain version not timed); every
    form (product or sum, prefix or suffix, inclusive or exclusive) over Fr
    and Fq at ragged n, zeros at the first and last rows.  No PyTorch call
    scans modulo p (library_ms null).  K13 on the total of a 2^20 product,
    and on edge values and random rows over both fields."""
    import torch
    from plonkit_tpu_torch.gpu import field_kernels as fk, fixed_base, mont
    from plonkit_tpu_torch.gpu.mont import FQ, FR, to_tensor
    rng = np.random.default_rng(SEED + 9)
    n = 1 << KERNEL_LOG2
    x = to_tensor(_planted_zeros(_random_fr_rows(rng, n, 0), "last"), DEVICE)

    def forms(spec, t, op, reverse, exclusive):
        return (lambda: fk.scan(spec, t, op, reverse, exclusive),
                lambda: fk.scan_plain(spec, t, op, reverse, exclusive))

    def bound(rows, op):
        bytes_s = 64 * rows / HBM_BYTES_PER_S
        ops_s = (rows - 1) * MONT_MUL_OPS * (op == "mul") / INT32_MUL_PER_S
        return {"bound_ms": max(bytes_s, ops_s) * 1e3,
                "bound_by": "bytes" if bytes_s >= ops_s else "operations"}

    variants = {}
    kern, plain = forms(FR, x, "add", True, True)
    got = kern()
    want, plain_ms = _timed_once(plain)
    variants["Fr exclusive suffix sum, 2^20 (divide_by_linear)"] = dict(
        mismatches=_mismatches((got,), (want,)), ms=time_ms(kern, 20), plain_ms=plain_ms,
        library_ms=None, **bound(n, "add"))
    del got, want
    part = fixed_base.CRS_CHUNK_LOG2        # the points of an SRS part
    xq = to_tensor(_random_fr_rows(rng, 1 << part, 0), DEVICE)
    kern, plain = forms(FQ, xq, "mul", False, False)
    variants[f"Fq inclusive prefix product, 2^{part} (an SRS part)"] = dict(
        mismatches=_mismatches((kern(),), (plain(),)), ms=time_ms(kern, 5), plain_ms=None,
        library_ms=None, **bound(1 << part, "mul"))
    del xq
    ragged = {}
    for spec in (FR, FQ):
        for m in SCAN_RAGGED:
            t = to_tensor(_planted_zeros(_planted_zeros(_random_fr_rows(rng, m), "first"),
                                         "last"), DEVICE)
            ragged[f"{'Fr' if spec is FR else 'Fq'} n = {m}"] = sum(
                _mismatches((k(),), (p(),))
                for op in ("mul", "add") for rev in (False, True) for exc in (False, True)
                for k, p in [forms(spec, t, op, rev, exc)])
    kern, plain = forms(FR, x, "mul", False, True)
    k12 = _row("K12 field_scan", kern, plain, n, 64 * n, (n - 1) * MONT_MUL_OPS, 20,
               shape="Fr exclusive prefix product, 2^20 (the grand product)",
               variants=variants, ragged_mismatches=ragged,
               note="a parallel scan does >= 2 products a row (this one 2.31); the bound "
                    "counts the n - 1 of the serial scan")
    k12["mismatches"] += sum(v["mismatches"] for v in variants.values()) + sum(ragged.values())

    total = fk.scan(FR, x[4:-1].contiguous(), "mul")[-1:].contiguous()
    steps = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    fk.inverse(FR, total, steps)
    count, k = int(steps[0]) & 0xFFFF, int(steps[0]) >> 16
    edge = {}
    for spec in (FR, FQ):
        t = torch.cat([to_tensor(spec.to_mont_np([0, 1, 2, spec.p - 1, spec.p - 2]), DEVICE),
                       to_tensor(_random_fr_rows(rng, 59), DEVICE)])
        edge["Fr" if spec is FR else "Fq"] = _mismatches((fk.inverse(spec, t),),
                                                         (mont.inverse(spec, t),))
    # the multiplies this input needs: the 2^-k fix-up's 32 x 256-bit
    # products (17 instructions, 31 bits each) and the last Montgomery product
    k13 = _row("K13 field_inverse", lambda: fk.inverse(FR, total),
               lambda: mont.inverse(FR, total), 1, 64, MONT_MUL_OPS + 17 * -(-k // 31), 20,
               warm_plain=False, steps=count, shifted_bits=k,
               edge_and_random_mismatches=edge,
               note="one thread: bound by the latency of its dependent steps, not by the "
                    "bytes or operations counted here")
    k13["mismatches"] += sum(edge.values())
    return [k12, k13]


def _dtoh_copies(fn) -> dict:
    """Device-to-host copies and K12 launches torch.profiler records in
    one call of fn."""
    import torch
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    return {"dtoh": sum("DtoH" in nm for nm in names),
            "k12_events": sum("field_scan" in nm for nm in names)}


def _batch_inverse_record() -> dict:
    """gpu/field_kernels.batch_inverse over Fr at 2^20 (pallas_kernels.py:173
    batch_inverse): two K12 launches and one K13, no K1, nothing read back.
    Its ms (CUDA events over 20 calls), launches a call and bound; the plain
    version (batch_inverse_plain: Hillis-Steele scans of plain products, the
    total inverted on the host) timed on the same input; mismatches
    against it there (zeros at the first and last rows) and at ragged n
    with zeros at the first row, the last, every third and everywhere (Fr
    and Fq); x * x^-1 = 1 on the nonzero rows; and the device-to-host
    copies torch.profiler records in one batch_inverse call and one
    TorchBackend.grand_product call (none may happen)."""
    import torch
    from plonkit_tpu_torch.backend_torch import FrVec, TorchBackend
    from plonkit_tpu_torch.gpu import field_kernels as fk
    from plonkit_tpu_torch.gpu.mont import FQ, FR, to_tensor
    rng = np.random.default_rng(SEED + 7)
    n = 1 << KERNEL_LOG2
    v = to_tensor(_planted_zeros(_random_fr_rows(rng, n, 0), "last"), DEVICE)
    zero = (v == 0).all(dim=1)
    before = dict(fk.launches)
    inv = fk.batch_inverse(FR, v)
    per_call = {k: fk.launches[k] - before[k] for k in ("mul", "scan", "inverse")}
    one = fk.mul(FR, v, inv)
    ok = bool(torch.equal(one[~zero], FR.const(1, int((~zero).sum()), DEVICE))
              and not inv[zero].any())
    want, plain_ms = _timed_once(lambda: fk.batch_inverse_plain(FR, v))
    mism = _mismatches((inv,), (want,))
    ragged = {}
    for spec in (FR, FQ):
        for m in SCAN_RAGGED:
            rows = _random_fr_rows(rng, m)
            ragged[f"{'Fr' if spec is FR else 'Fq'} n = {m}"] = sum(
                _mismatches((fk.batch_inverse(spec, t),), (fk.batch_inverse_plain(spec, t),))
                for t in [to_tensor(_planted_zeros(rows, z), DEVICE) for z in ZERO_PATTERNS])
    copies = {"batch_inverse": _dtoh_copies(lambda: fk.batch_inverse(FR, v)),
              "grand_product": _dtoh_copies(
                  lambda: TorchBackend(DEVICE).grand_product(FrVec(v)))}
    # the function's own bound: n rows read and written once, and three
    # Montgomery products a row (prefix, suffix, the inverse's combine)
    bytes_s = 2 * 32 * n / HBM_BYTES_PER_S
    ops_s = 3 * MONT_MUL_OPS * n / INT32_MUL_PER_S
    return {"name": "batch_inverse", "replaces": "plonkit_tpu/tpu/pallas_kernels.py:173",
            "elements": n, "inverse_checked": ok, "launches_per_call": per_call,
            "mismatches": mism + sum(ragged.values()), "ragged_mismatches": ragged,
            "ms": time_ms(lambda: fk.batch_inverse(FR, v), 20), "plain_ms": plain_ms,
            "bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "profiled_calls": copies}


GROUP_NTT_CHECK_LANES = 1 << 12   # lanes of K14 / K15 held against their plain versions
# 32-bit multiplies of one Montgomery squaring: 36 distinct wide products
# of the 8 x 8 limbs instead of 64, the reduction as in MONT_MUL_OPS
MONT_SQR_OPS = 2 * (36 + 64) + 8
# the point operations of ec.cuh with their squarings at their own cost:
# dbl-2009-l 2M + 5S, add-2007-bl 12M + 4S, and the add that takes its
# doubling fallback after 6M + 2S (T[2] = T[1] + P of the ladder's table)
DBL_OPS = 2 * MONT_MUL_OPS + 5 * MONT_SQR_OPS
ADD_OPS = 12 * MONT_MUL_OPS + 4 * MONT_SQR_OPS
TABLE_OPS = 13 * ADD_OPS + 6 * MONT_MUL_OPS + 2 * MONT_SQR_OPS + DBL_OPS


def _ladder_ops(scalars: np.ndarray, glv: bool) -> np.ndarray:
    """32-bit multiplies of [s]P for each [8] uint32 canonical scalar row:
    none for 0 or 1, else the 4-bit window table, four doublings a window
    below the top non-zero one and one add for each non-zero digit there
    (csrc/group_ntt.cu's ladder).  With `glv`, the work the function
    needs with BN254's endomorphism, phi(x, y) = (beta x, y) = [lambda]P:
    s = k1 + k2 lambda with halves of about 127 bits takes half the
    doublings, the same count of window adds, and the table of phi(P) at
    one product an entry besides P's."""
    shifts = np.arange(0, 32, 4, dtype=np.uint64)
    digits = ((scalars.astype(np.uint64)[:, :, None] >> shifts) & 15).reshape(-1, 64)
    nonzero = digits != 0
    top = np.where(nonzero.any(axis=1), 63 - np.argmax(nonzero[:, ::-1], axis=1), -1)
    adds = nonzero.sum(axis=1) - (top >= 0)
    doublings = 4 * np.maximum(top, 0) // (2 if glv else 1)
    ops = (TABLE_OPS + 15 * MONT_MUL_OPS * glv + doublings * DBL_OPS + adds * ADD_OPS)
    return np.where((top <= 0) & (digits[:, 0] <= 1), 0, ops)


def _group_ntt_rows(ctx) -> list:
    """K14 g1_butterfly and K15 g1_scale at the main path's shapes: K14 on
    stage 0 of a 2^20-point inverse transform (2^19 butterflies, the
    twiddles w^-j), K15 on the 2^20 points of its 1/n.  The points are SRS
    bases summed in pairs by K7 (Z != 1, as a later stage sees them), with
    lo, hi or both at infinity, lo = [w]hi and lo = -[w]hi planted in
    lanes 256 ... 1280.  The output of one launch is kept and every 128th
    (K14) or 256th (K15) lane of it, 2^12 lanes, is held limb for limb
    against the plain version run on those lanes' inputs (the plain ladder
    is some hundred sequential point operations whatever the lanes);
    plain_ms is that call's.  bound_ms counts what [w]P needs (_ladder_ops
    with glv); ladder_bound_ms the kernel's own ladder, squarings at their
    own cost in both."""
    import torch
    from plonkit_tpu_torch.curve import g1_mul, g1_neg
    from plonkit_tpu_torch.fields import fr_inv, get_domain_omega
    from plonkit_tpu_torch.gpu import ec, field_kernels as fk, group_ntt, msm_kernels as mk, ntt
    from plonkit_tpu_torch.gpu.mont import FR, to_numpy
    n = 1 << MAIN_LOG2
    half = n // 2
    base = ec.jacobian_from_affine((ctx.table[:n, :8].contiguous(),
                                    ctx.table[:n, 8:].contiguous(),
                                    torch.zeros(n, dtype=torch.bool, device=DEVICE)))
    pts = mk.padd(base, tuple(a.roll(1, 0).contiguous() for a in base))
    del base
    pows = ntt.powers(fr_inv(get_domain_omega(n)), half, DEVICE)
    tw = fk.mul(FR, pows, FR.const_raw(1, half, DEVICE))    # w^-j, canonical
    lo, hi = tuple(a[:half] for a in pts), tuple(a[half:] for a in pts)   # views of pts
    for a in lo:
        a[256], a[768] = 0, 0
    for a in hi:
        a[512], a[768] = 0, 0
    lanes = [1024, 1280]
    ws = FR.from_limbs_np(to_numpy(tw[lanes]))
    hs = ec.to_affine_host(tuple(a[lanes] for a in hi))
    planted = ec.jacobian_from_affine(ec.affine_from_host(
        [g1_mul(hs[0], ws[0]), g1_neg(g1_mul(hs[1], ws[1]))], DEVICE))
    for a, b in zip(lo, planted):
        a[lanes] = b
    at = torch.arange(0, half, half // GROUP_NTT_CHECK_LANES, device=DEVICE)
    got = group_ntt.g1_butterfly(lo, hi, tw)
    got = tuple(c[at] for c in got[0] + got[1])
    want, plain_ms = _timed_once(lambda: group_ntt.g1_butterfly_plain(
        tuple(a[at] for a in lo), tuple(a[at] for a in hi), tw[at]))
    want = want[0] + want[1]
    stride = half // GROUP_NTT_CHECK_LANES
    infinite = {"lo - [w]hi at lane 1024 (lo = [w]hi)": bool((got[5][1024 // stride] == 0).all()),
                "lo + [w]hi at lane 1280 (lo = -[w]hi)": bool((got[2][1280 // stride] == 0).all())}
    scalars = to_numpy(tw)
    fn_ops, ladder_ops = (int(_ladder_ops(scalars, glv).sum()) + 2 * ADD_OPS * half
                          for glv in (True, False))
    bytes_moved = half * (4 * POINT_BYTES + 32)
    k14 = _row_of("K14 g1_butterfly", half,
                  time_ms(lambda: group_ntt.g1_butterfly(lo, hi, tw), 3), plain_ms,
                  _mismatches(got, want) + sum(not v for v in infinite.values()),
                  _max_abs_err(got, want), bytes_moved, fn_ops,
                  compared_elements=GROUP_NTT_CHECK_LANES, plain_elements=GROUP_NTT_CHECK_LANES,
                  planted_infinity=infinite,
                  ladder_bound_ms=max(bytes_moved / HBM_BYTES_PER_S,
                                      ladder_ops / INT32_MUL_PER_S) * 1e3,
                  note=f"ms and bound at 2^{MAIN_LOG2 - 1} butterflies (stage 0 of a "
                       f"2^{MAIN_LOG2}-point inverse transform); the comparison and "
                       f"plain_ms on one lane in {stride} of the "
                       f"launch kept; bound_ms with GLV, ladder_bound_ms the kernel's ladder")
    inv_n = fr_inv(n)
    at = torch.arange(0, n, n // GROUP_NTT_CHECK_LANES, device=DEVICE)
    got = tuple(c[at] for c in group_ntt.g1_scale(pts, inv_n))
    want, plain_ms = _timed_once(lambda: group_ntt.g1_scale_plain(
        tuple(a[at] for a in pts), inv_n))
    inv_limbs = FR.to_limbs_np([inv_n])
    fn_ops, ladder_ops = (int(_ladder_ops(inv_limbs, glv)[0]) * n for glv in (True, False))
    bytes_moved = n * 2 * POINT_BYTES + 32
    k15 = _row_of("K15 g1_scale", n, time_ms(lambda: group_ntt.g1_scale(pts, inv_n), 3),
                  plain_ms, _mismatches(got, want), _max_abs_err(got, want),
                  bytes_moved, fn_ops, compared_elements=GROUP_NTT_CHECK_LANES,
                  plain_elements=GROUP_NTT_CHECK_LANES,
                  infinite_lanes_kept=bool((got[2][[256 // stride // 2, 768 // stride // 2]] == 0).all()),
                  ladder_bound_ms=max(bytes_moved / HBM_BYTES_PER_S,
                                      ladder_ops / INT32_MUL_PER_S) * 1e3,
                  note=f"ms and bound at the 2^{MAIN_LOG2} points of a transform's 1/n; "
                       f"the comparison and plain_ms on one lane in {n // GROUP_NTT_CHECK_LANES}"
                       f" of the launch kept; bound_ms with GLV, ladder_bound_ms the "
                       f"kernel's ladder")
    if not k15["infinite_lanes_kept"]:
        k15["mismatches"] += 1
    return [k14, k15]


def phase_kernels(ctx) -> list:
    t0 = time.perf_counter()
    rows = (_field_rows() + _msm_rows(ctx) + _ntt_mxu_rows() + _scan_rows()
            + _group_ntt_rows(ctx))
    binv = _batch_inverse_record()
    emit({"phase": "kernels", "seconds": round(time.perf_counter() - t0, 3),
          "batch_inverse": binv,
          "mismatches": {r["name"]: r["mismatches"] for r in rows},
          "batched_mismatches": {r["name"]: r["batched"]["mismatches"]
                                 for r in rows if "batched" in r}})
    bad = [r["name"] for r in rows
           if r["mismatches"] or r.get("batched", {}).get("mismatches")]
    copies = binv["profiled_calls"]
    if (not binv["inverse_checked"] or binv["mismatches"] or any(c["dtoh"] for c in copies.values())
            or not all(c["k12_events"] for c in copies.values())
            or binv["launches_per_call"] != {"mul": 0, "scan": 2, "inverse": 1}):
        bad.append("batch_inverse")
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
    from plonkit_tpu_torch.gpu import (field_kernels as fk, group_ntt, msm_kernels as mk, ntt,
                                       ntt_mxu)
    for counts in (fk.launches, ntt.launches, mk.launches, ntt_mxu.launches, group_ntt.launches):
        for k in counts:
            counts[k] = 0


def _launch_counts() -> dict:
    """Launches of every kernel since the last _reset_launches, by row name."""
    from plonkit_tpu_torch.gpu import (field_kernels as fk, group_ntt, msm_kernels as mk, ntt,
                                       ntt_mxu)
    return {"K1 mul": fk.launches["mul"], "K2a add": fk.launches["add"],
            "K2b sub": fk.launches["sub"], "K3 butterfly_dif": ntt.launches["butterfly_dif"],
            "K4 mul_add": fk.launches["mul_add"], "K5 butterfly": ntt.launches["butterfly"],
            "K6 bucket_sweep": mk.launches["bucket_sweep"], "K7 padd": mk.launches["padd"],
            "K7r segment_fold": mk.launches["segment_fold"],
            "K7w window_sums": mk.launches["window_sums"],
            "K8 combine": mk.launches["combine"],
            "K9 balanced_digits": ntt_mxu.launches["balanced_digits"],
            "K10 dft_product": ntt_mxu.launches["dft_product"],
            "K11 fold_redc": ntt_mxu.launches["fold_redc"],
            "K12 field_scan": fk.launches["scan"],
            "K13 field_inverse": fk.launches["inverse"],
            "K14 g1_butterfly": group_ntt.launches["g1_butterfly"],
            "K15 g1_scale": group_ntt.launches["g1_scale"]}


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


def _tampered(proof):
    """A copy of the proof with its first wire value at z changed."""
    from plonkit_tpu_torch.serialization import Proof
    out = Proof.read(io.BytesIO(proof.to_bytes()))
    out.wire_values_at_z[0] = (out.wire_values_at_z[0] + 1) % (1 << 253)
    return out


def phase_lagrange(setup, circuit, key: str, tmp: str, proof_bytes: bytes):
    """The main circuit's Lagrange key made on the card from the 2^23 key
    (api.crs_lagrange_form: 20 K14 stages, one K15, K12 and K13 for the
    affine conversion, K1) under torch.profiler, with its wall and device
    seconds and launches, written as a key file; then one prove with it
    (the prove -l path) from a copy of the setup, whose proof.bin must be
    the first proof's.  Returns the launches and the key file's sha256."""
    import torch
    from plonkit_tpu_torch.api import crs_lagrange_form
    from plonkit_tpu_torch.serialization import CrsHandle
    domain = setup.setup_polynomials.domain_size
    _reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        lagrange = crs_lagrange_form(CrsHandle(key), domain)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _launch_counts()
    kernels, busy, by_kernel = device_activity(prof)
    path = os.path.join(tmp, f"lagrange_2pow{MAIN_LOG2}.key")
    t0 = time.perf_counter()
    lagrange.save(path)
    save_s = time.perf_counter() - t0
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    l_setup = copy.copy(setup)
    l_setup.key_lagrange_form, l_setup._prover_ctx = lagrange, None
    t0 = time.perf_counter()
    same = l_setup.prove(circuit).to_bytes() == proof_bytes
    prove_s = time.perf_counter() - t0
    want = {"K14 g1_butterfly": domain.bit_length() - 1, "K15 g1_scale": 1}
    emit({"phase": "lagrange", "domain": domain, "dump_wall_s": wall, "device_busy_s": busy,
          "device_events": len(kernels), "by_kernel": by_kernel, "save_s": save_s,
          "key_sha256": digest, "prove_l_s": prove_s, "prove_l_equals_first_proof": same,
          "launches": launches})
    if not same:
        raise AssertionError("the prove with the Lagrange key gave other bytes")
    if any(launches[k] != v for k, v in want.items()) or not all(
            launches[k] for k in ("K1 mul", "K12 field_scan", "K13 field_inverse")):
        raise AssertionError(f"the Lagrange dump's launches: {launches}, expected {want} "
                             "and K1, K12, K13")
    return launches, digest


def phase_main(key: str):
    from plonkit_tpu_torch import profiling
    from plonkit_tpu_torch.api import SetupForProver, verify
    from plonkit_tpu_torch.frontend.synthetic import synth_circuit
    from plonkit_tpu_torch.gpu import msm_kernels as mk
    from plonkit_tpu_torch.serialization import CrsHandle
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
        stages = dict(profiling.last_timings)
    launches = _launch_counts()
    commitments = mk.launches["bucket_sweep"]
    per_commitment = (mk.launches["segment_fold"] + mk.launches["window_sums"]
                      + mk.launches["padd"]) / max(1, commitments)
    engines = _warm_proves_by_engine(setup, circuit)
    digest = hashlib.sha256(proof.to_bytes()).hexdigest()
    same_engines = {e: r["proof_sha256"] == digest for e, r in engines.items()}
    launches_pease = engines["pease"]["launches"]
    host_msm = stages.get("host msm", 0.0)

    t0 = time.perf_counter()
    ok = verify(vk, proof)
    rejected = not verify(vk, _tampered(proof))
    times["verify"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    same = _host_commit_reference(key)
    times["host_commit_reference"] = time.perf_counter() - t0

    emit({"phase": "main", "domain": domain, "msm": "device",
          "verified": ok, "tampered_rejected": rejected,
          "identical_to_host_commitments": same,
          "host_commit_reference_domain": 1 << REFERENCE_LOG2,
          "warm_prove_by_ntt_engine": engines, "first_proof_sha256": digest,
          "engines_give_the_first_proof": same_engines,
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
    if not all(same_engines.values()):
        raise AssertionError(f"the NTT engines give other proof bytes: {engines}")
    if host_msm:
        raise AssertionError("a commitment of the main path ran on the host")
    if per_commitment > REDUCTION_LAUNCHES_MAX:
        raise AssertionError(f"{per_commitment} reduction launches a commitment, "
                             f"more than {REDUCTION_LAUNCHES_MAX}")
    if sum(groups) != commitments or launches["K8 combine"] != len(groups):
        raise AssertionError(f"K8 launched {launches['K8 combine']} times and K6 "
                             f"{commitments} for the commitment groups {groups}: one K8 "
                             "launch a group expected")
    # under auto the tensor cores take every transform of this path; the
    # butterflies must launch in the pease prove instead, the group NTT in
    # the Lagrange dump (phase_lagrange)
    idle = [k for k, v in launches.items() if v == 0 and k not in BUTTERFLIES + GROUP_NTT]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    idle = [k for k in BUTTERFLIES if launches_pease[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched in the pease prove: {idle}")
    profile_prove(setup, circuit, vk)
    return launches, launches_pease, circuit, vk.to_bytes(), proof.to_bytes(), setup


def _host_commit_reference(key: str) -> dict:
    """The synthetic chain at a 2^REFERENCE_LOG2 domain: vk.bin and proof.bin
    with commitments on the card, then from the same setup with every
    commitment in the host Pippenger.  Whether the bytes are equal."""
    from plonkit_tpu_torch.api import SetupForProver
    from plonkit_tpu_torch.frontend.synthetic import synth_circuit
    from plonkit_tpu_torch.serialization import CrsHandle
    circuit = synth_circuit(REFERENCE_LOG2 - 1)
    setup = SetupForProver(circuit, CrsHandle(key), device=DEVICE)
    if setup.setup_polynomials.domain_size != 1 << REFERENCE_LOG2:
        raise AssertionError(f"reference domain {setup.setup_polynomials.domain_size}")
    vk, proof = setup.make_verification_key(), setup.prove(circuit)
    ref = copy.copy(setup)
    ref.backend, ref._prover_ctx = _host_commit_backend(), None
    return {"vk.bin": ref.make_verification_key().to_bytes() == vk.to_bytes(),
            "proof.bin": ref.prove(circuit).to_bytes() == proof.to_bytes()}


@contextlib.contextmanager
def _ntt_engine(engine: str):
    """backend_torch's NTT engine set to `engine` (the value PLONKIT_TPU_NTT
    gives it when the process starts) for the block."""
    from plonkit_tpu_torch import backend_torch
    saved, backend_torch._NTT_ENGINE = backend_torch._NTT_ENGINE, engine
    try:
        yield
    finally:
        backend_torch._NTT_ENGINE = saved


def _warm_proves_by_engine(setup, circuit) -> dict:
    """A warm prove under each NTT engine: auto (on the card the tensor
    cores for every transform of 512 points or more) and pease (the
    butterflies; its first use in the process, so its time includes
    building its twiddle tables).  Each proof.bin's sha256, wall s and
    the launches of every kernel in that prove alone."""
    import torch
    out = {}
    for engine in ("auto", "pease"):
        with _ntt_engine(engine):
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blob = setup.prove(circuit).to_bytes()
            torch.cuda.synchronize()
            out[engine] = {"prove_warm_s": time.perf_counter() - t0,
                           "proof_sha256": hashlib.sha256(blob).hexdigest(),
                           "launches": _launch_counts()}
    return out


def _prove_twice(setup, circuit, times: dict, label: str = ""):
    """vk, the first prove (its prover context included) and a warm one,
    each timed into `times`; returns vk, the first proof and its stages."""
    from plonkit_tpu_torch import profiling
    t0 = time.perf_counter()
    vk = setup.make_verification_key()
    times[label + "vk"] = time.perf_counter() - t0
    profiling.reset()
    t0 = time.perf_counter()
    proof = setup.prove(circuit)
    times[label + "prove"] = time.perf_counter() - t0
    stages = dict(profiling.last_timings)
    t0 = time.perf_counter()
    warm = setup.prove(circuit)
    times[label + "prove warm"] = time.perf_counter() - t0
    if warm.to_bytes() != proof.to_bytes():
        raise AssertionError(f"{label or 'a '}warm prove gave other bytes")
    return vk, proof, stages


def phase_poseidon(tmp: str, key: str):
    """The Poseidon chain at 2^20 over the tau = 42 key, then over a foreign
    key of a seeded random tau.  Returns the setup, the circuit and the
    tau = 42 vk and proof bytes."""
    import random
    import torch
    from plonkit_tpu_torch.api import SetupForProver, verify
    from plonkit_tpu_torch.backend_torch import TorchBackend
    from plonkit_tpu_torch.curve import G2_GEN, g2_mul
    from plonkit_tpu_torch.fields import FR_MODULUS
    from plonkit_tpu_torch.frontend.poseidon import poseidon_circuit
    from plonkit_tpu_torch.frontend.synthetic import poseidon_chain_circuit
    from plonkit_tpu_torch.gpu.fixed_base import gen_crs_g1_device
    from plonkit_tpu_torch.serialization import CrsHandle, save_crs_g1_limbs
    t_all = time.perf_counter()
    times = {}
    t0 = time.perf_counter()
    circuit = poseidon_chain_circuit(POSEIDON_LOG2)
    times["circuit"] = time.perf_counter() - t0
    # one constraint binds the output; the rest are the chain's hashes
    per_hash = len(poseidon_circuit(2, chain=1)[0].r1cs.constraints) - 1
    hashes = (len(circuit.r1cs.constraints) - 1) / per_hash
    _reset_launches()
    t0 = time.perf_counter()
    setup = SetupForProver(circuit, CrsHandle(key), device=DEVICE)
    times["setup"] = time.perf_counter() - t0
    domain = setup.setup_polynomials.domain_size
    gates = setup._witness_plan.tc.num_constraint_gates
    vk, proof, stages = _prove_twice(setup, circuit, times)
    launches = _launch_counts()
    t0 = time.perf_counter()
    checks = {"verified": verify(vk, proof), "tampered_rejected": not verify(vk, _tampered(proof)),
              "domain_2pow20": domain == 1 << POSEIDON_LOG2, "hashes": hashes == POSEIDON_HASHES}
    times["verify"] = time.perf_counter() - t0

    # a foreign SRS: a seeded random tau, the key made on the card
    tau = random.Random(SEED + 5).randrange(2, FR_MODULUS)
    foreign = os.path.join(tmp, f"foreign_2pow{POSEIDON_LOG2}.key")
    t0 = time.perf_counter()
    x, y, inf = gen_crs_g1_device(POSEIDON_LOG2, tau, DEVICE)
    save_crs_g1_limbs(foreign, x, y, inf, [G2_GEN, g2_mul(G2_GEN, tau)])
    torch.cuda.synchronize()
    times["foreign key"] = time.perf_counter() - t0
    handle = CrsHandle(foreign)
    other = copy.copy(setup)
    other.crs, other.backend, other._prover_ctx = handle, TorchBackend(DEVICE), None
    t0 = time.perf_counter()
    vk_f = other.make_verification_key()
    proof_f = other.prove(circuit)
    times["foreign vk + prove"] = time.perf_counter() - t0
    checks.update({
        "foreign key read back": handle.num_g1 == 1 << POSEIDON_LOG2
        and handle.g2_monomial_bases == [G2_GEN, g2_mul(G2_GEN, tau)],
        "foreign verified": verify(vk_f, proof_f),
        "foreign rejected by the tau = 42 vk": not verify(vk, proof_f),
        "foreign vk differs": vk_f.to_bytes() != vk.to_bytes()})
    emit({"phase": "poseidon", "domain": domain, "hashes": hashes, "gates": gates,
          "constraints": len(circuit.r1cs.constraints), "checks": checks,
          "seconds": {k: round(v, 3) for k, v in times.items()},
          "stages_s": {k: round(v, 3) for k, v in stages.items()},
          "launches": launches, "total_s": round(time.perf_counter() - t_all, 3)})
    if not all(checks.values()):
        raise AssertionError(f"the Poseidon chain at 2^{POSEIDON_LOG2} fails: {checks}")
    return setup, circuit, vk.to_bytes(), proof.to_bytes()


def phase_mesh(setup, circuit, vk_bytes: bytes, proof_bytes: bytes) -> dict:
    """The Poseidon setup on MeshBackend over a one-rank NCCL world: the
    same bytes; the launches of every kernel on the mesh path."""
    from plonkit_tpu_torch.parallel.backend_mesh import MeshBackend
    t_all = time.perf_counter()
    backend = MeshBackend(device=DEVICE)
    mesh_setup = copy.copy(setup)
    mesh_setup.backend, mesh_setup._prover_ctx = backend, None
    _reset_launches()
    backend.mesh.reset_counts()
    times = {}
    vk, proof, stages = _prove_twice(mesh_setup, circuit, times)
    launches = _launch_counts()
    same = {"vk.bin": vk.to_bytes() == vk_bytes, "proof.bin": proof.to_bytes() == proof_bytes}
    emit({"phase": "mesh", "domain": setup.setup_polynomials.domain_size,
          "world": backend.D, "process_group": backend.mesh.backend,
          "identical_to_poseidon_phase": same,
          "seconds": {k: round(v, 3) for k, v in times.items()},
          "stages_s": {k: round(v, 3) for k, v in stages.items()},
          "distributed": dict(backend.distributed), "gathered": dict(backend.gathered),
          "collectives": backend.mesh.counts, "launches": launches,
          "total_s": round(time.perf_counter() - t_all, 3)})
    if not all(same.values()):
        raise AssertionError(f"the mesh gives other bytes than one device: {same}")
    if backend.gathered.get("commit") or not backend.distributed.get("commit"):
        raise AssertionError("a commitment of the mesh path left DistributedMSMContext")
    # the mesh's 4-step runs on the butterflies (parallel/ntt.py), as the
    # JAX package's does, so the tensor-core NTT may idle
    idle = [k for k, v in launches.items()
            if v == 0 and k != "K2b sub" and k not in TENSOR_CORE_NTT + GROUP_NTT]
    if idle:
        raise AssertionError(f"kernels never launched on the mesh path: {idle}")
    return launches


def phase_mesh_ranks(tmp: str, key: str) -> None:
    """dryrun_multichip on MESH_RANKS gloo ranks sharing the card."""
    from plonkit_tpu_torch.parallel.dryrun import dryrun_multichip
    built = _build_snapshot()
    out = dryrun_multichip(MESH_RANKS, DEVICE, "gloo", key=key, timeout_s=600, workdir=tmp)
    chain = out["chain"]
    checks = {
        "fixture vk.bin": out["fixture_64"]["vk.bin = fixture vk.bin"],
        "fixture proof_0.bin": out["fixture_64"]["rescue proof = fixture proof_0.bin"],
        "msm uniform": out["msm"]["uniform"]["equal"],
        "msm 0/1 padded": out["msm"]["zero_one_padded"]["equal"],
        "ntt": out["ntt"]["ntt"], "intt": out["ntt"]["intt"],
        "round trip": out["ntt"]["round_trip"],
        "chain vk.bin": chain["vk.bin = one device"],
        "chain proof.bin": chain["proof.bin = one device"],
        "chain commitments all distributed": chain["distributed"].get("commit", 0) > 0
        and not chain["gathered"].get("commit"),
        "no library rebuilt": _build_snapshot() == built}
    emit({"phase": "mesh_ranks", "ranks": out["ranks"], "process_group": out["backend"],
          "device": out["device"], "checks": checks,
          "chain_domain": chain["domain"], "ntt_points": out["ntt"]["points"],
          "msm_points": {k: v["points"] for k, v in out["msm"].items()},
          "chain_distributed": chain["distributed"], "chain_gathered": chain["gathered"],
          "collectives_rank0": out["collectives"],
          "seconds": {k: round(v, 3) for k, v in out["seconds"].items()},
          "total_s": round(out["wall_s"], 3)})
    if not all(checks.values()):
        raise AssertionError(f"the {MESH_RANKS}-rank mesh on the card fails: {checks}")


def _build_snapshot() -> dict:
    """name -> (size, mtime) of every built library, to show that no CLI
    process rebuilt one."""
    from plonkit_tpu_torch.gpu import build
    return {f: (st.st_size, st.st_mtime_ns) for f in sorted(os.listdir(build.BUILD_DIR))
            for st in [os.stat(os.path.join(build.BUILD_DIR, f))]}


def _same_file(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def inner_proof_path(tmp: str, i: int) -> str:
    """Phase 7's rescue proof of gen_inner_circuit.py's witness_<i>.json."""
    return os.path.join(tmp, "cli64", f"proof_{i}.bin")


def _inner_prove(tmp: str, i: int, backend: str, key: str = "setup.key") -> list:
    """The CLI's arguments for the rescue prove of witness_<i>.json on
    `backend`: the card's into inner_proof_path, the CPU's beside it."""
    gen = os.path.join(tmp, "inner")
    out = f"proof_{i}" if backend == "cuda" else f"proof_{i}_cpu"
    return ["--backend", backend, "prove", "-m", key,
            "-c", os.path.join(gen, "circuit.r1cs.json"),
            "-w", os.path.join(gen, f"witness_{i}.json"), "-t", "rescue",
            "-p", out + ".bin", "-j", out + ".json", "-i", out.replace("proof", "public") + ".json"]


def start_cpu_calls(tmp: str, key: str, pool) -> dict:
    """Phase 7's calls that use no card, started in `pool` once phase 2's
    key exists, so that they run beside phases 3-6 and not in the wave of
    phases 7-10: scripts/gen_inner_circuit.py writes the circuit and
    AGG_PROOFS witnesses, then the rescue proves of witness_2 ...
    witness_4 and the fixture's dump-lagrange with --backend cpu, over the
    first points of phase 2's key (those of phase 7's setup -p 10, which
    phase 7 checks).  Each takes one CPU thread, so that the four leave
    the host's other cores to phases 3-6, whose host times they would
    otherwise stretch.  Returns {label: future of the call's wall
    seconds}."""
    d = os.path.join(tmp, "cli64")
    os.makedirs(d)
    gen = os.path.join(tmp, "inner")
    os.makedirs(gen)
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "gen_inner_circuit.py"), gen,
                    str(AGG_PROOFS)], check=True, capture_output=True, timeout=120)
    calls = {f"--backend cpu prove -t rescue witness_{i}": _inner_prove(tmp, i, "cpu", key)
             for i in INNER}
    calls["--backend cpu dump-lagrange"] = ["--backend", "cpu", "dump-lagrange", "-m", key,
                                            "-l", "lagrange_cpu.key",
                                            "-c", os.path.join(FIXTURES, "circuit.r1cs.json")]
    return {label: pool.submit(cli, *args, cwd=d, threads=1) for label, args in calls.items()}


def phase_inner_proofs(tmp: str) -> dict:
    """Phase 7's first waves: setup -p 10 and analyse, then the rescue
    proofs of witness_2 ... witness_4 on the card, the inner proofs that
    phase 10 aggregates beside the fixture's pair.  Returns the wall
    seconds of each call."""
    t_all = time.perf_counter()
    d = os.path.join(tmp, "cli64")
    s = cli_together(("setup", ["setup", "-p", "10", "-m", "setup.key"]),
                     ("analyse", ["analyse", "-c", os.path.join(FIXTURES, "circuit.r1cs.json"),
                                  "-o", "analyse.json"]), cwd=d)
    s.update(cli_together(*[(f"prove -t rescue witness_{i}", _inner_prove(tmp, i, "cuda"))
                            for i in INNER], cwd=d))
    s["inner proofs"] = time.perf_counter() - t_all
    return s


def phase_cli(tmp: str, s: dict, cpu_calls: dict) -> None:
    """The base subcommands on the in-repo domain-64 circuit, on the card,
    after phase_inner_proofs (whose seconds `s` holds); the inner proofs
    and dump-lagrange on the CPU (start_cpu_calls' `cpu_calls`), each equal
    to the card's.  Calls that do not need each other's files run at
    once."""
    t_all = time.perf_counter()
    d = os.path.join(tmp, "cli64")
    circuit = os.path.join(FIXTURES, "circuit.r1cs.json")
    witness = os.path.join(FIXTURES, "witness_0.json")
    s.update(cli_together(
        ("export-verification-key", ["export-verification-key", "-m", "setup.key",
                                     "-c", circuit, "-v", "vk.bin"]),
        ("prove", ["prove", "-m", "setup.key", "-c", circuit, "-w", witness]),
        ("dump-lagrange", ["dump-lagrange", "-m", "setup.key", "-l", "lagrange.key",
                           "-c", circuit]),
        ("--backend mesh prove", ["--backend", "mesh", "prove", "-m", "setup.key", "-c", circuit,
                                  "-w", witness, "-p", "proof_mesh.bin", "-j", "proof_mesh.json",
                                  "-i", "public_mesh.json"]), cwd=d))
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
        ("prove -t rescue", ["prove", "-m", "setup.key", "-c", circuit, "-w",
                             os.path.join(AGG_FIXTURES, "witness_0.json"), "-t", "rescue",
                             "-p", "proof_rescue.bin", "-j", "proof_rescue.json",
                             "-i", "public_rescue.json"]), cwd=d))
    s.update(cli_together(
        ("verify -t rescue", ["verify", "-p", "proof_rescue.bin", "-v", "vk.bin", "-t", "rescue"]),
        *[(f"verify -t rescue proof_{i}", ["verify", "-p", f"proof_{i}.bin", "-v", "vk.bin",
                                           "-t", "rescue"]) for i in INNER], cwd=d))
    s.update({label: f.result() for label, f in cpu_calls.items()})
    with open(os.path.join(d, "analyse.json")) as f:
        stats = json.load(f)
    with open(os.path.join(d, "verifier.sol")) as f:
        sol = f.read()
    n = 1 << 10
    with open(os.path.join(d, "setup.key"), "rb") as f, \
            open(os.path.join(tmp, f"srs_2pow{SRS_LOG2}.key"), "rb") as big:
        small = f.read()
        g1 = big.read(8 + 64 * n)[8:]
        big.seek(8 + 64 * (1 << SRS_LOG2))
        g2 = big.read()
    same = {"setup -p 10 (card) = the first 2^10 points of phase 2's key":
                small[8:8 + 64 * n] == g1 and small[8 + 64 * n:] == g2,
            "dump-lagrange card = cpu": _same_file(os.path.join(d, "lagrange.key"),
                                                   os.path.join(d, "lagrange_cpu.key")),
            "vk.bin = fixture vk.bin": _same_file(os.path.join(d, "vk.bin"),
                                                  os.path.join(FIXTURES, "vk.bin")),
            "prove -l = prove": _same_file(os.path.join(d, "proof_l.bin"),
                                           os.path.join(d, "proof.bin")),
            "--backend mesh prove = prove": _same_file(os.path.join(d, "proof_mesh.bin"),
                                                       os.path.join(d, "proof.bin")),
            "prove -t rescue = fixture proof_0.bin": _same_file(
                os.path.join(d, "proof_rescue.bin"), os.path.join(AGG_FIXTURES, "proof_0.bin")),
            "gen_inner_circuit.py circuit = fixture circuit": _same_file(
                os.path.join(tmp, "inner", "circuit.r1cs.json"), circuit)}
    for i in INNER:
        same[f"proof_{i}.bin card = cpu"] = _same_file(inner_proof_path(tmp, i),
                                                      os.path.join(d, f"proof_{i}_cpu.bin"))
    emit({"phase": "cli", "domain": 64, "identical": same, "num_gates": stats["num_gates"],
          "contract_placeholders_left": sol.count("{{"),
          "seconds": {k: round(v, 3) for k, v in s.items()},
          "total_s": round(s["inner proofs"] + time.perf_counter() - t_all, 3)})
    if not all(same.values()) or "{{" in sol:
        raise AssertionError(f"CLI outputs differ: {same}, placeholders {sol.count('{{')}")


def phase_cli_full(tmp: str, key: str, circuit, vk_bytes: bytes, proof_bytes: bytes,
                   lagrange_sha256: str) -> None:
    """The main path's circuit through the CLI: its vk.bin and proof.bin
    must be the API's bytes, its lagrange.key the in-process key's (its
    sha256) and `prove -l`'s proof.bin the API's.  export-verification-key,
    prove and dump-lagrange run at once (each transpiles the circuit on the
    host), then prove -l and verify."""
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
                          ("prove", ["prove", "-m", key]),
                          ("dump-lagrange", ["dump-lagrange", "-m", key, "-l", "lagrange.key"]),
                          cwd=d))
    s.update(cli_together(("prove -l", ["prove", "-m", key, "-l", "lagrange.key",
                                        "-p", "proof_l.bin", "-j", "proof_l.json",
                                        "-i", "public_l.json"]),
                          ("verify", ["verify"]), cwd=d))

    def read(name):
        with open(os.path.join(d, name), "rb") as f:
            return f.read()
    same = {"vk.bin": read("vk.bin") == vk_bytes, "proof.bin": read("proof.bin") == proof_bytes,
            "lagrange.key sha256": hashlib.sha256(read("lagrange.key")).hexdigest()
            == lagrange_sha256,
            "prove -l proof.bin": read("proof_l.bin") == proof_bytes}
    emit({"phase": "cli_full", "domain": 1 << MAIN_LOG2, "identical_to_api": same,
          "seconds": {k: round(v, 3) for k, v in s.items()},
          "total_s": round(time.perf_counter() - t_all, 3)})
    if not all(same.values()):
        raise AssertionError(f"CLI and API bytes differ at 2^{MAIN_LOG2}: {same}")


def _flip_outer_input(blob: bytes) -> bytes:
    """A recursive_proof.bin with one bit of its outer public input flipped."""
    from plonkit_tpu_torch.recursive.aggregation import AggregatedProof
    out = bytearray(blob)
    outer = AggregatedProof.read(io.BytesIO(blob)).proof.to_bytes()
    out[len(out) - len(outer) + 16 + 31] ^= 1      # n, num_inputs, then input 0
    return bytes(out)


def _first_vk2_difference(path: str, want: str):
    """The first field (and item) of two recursive vks that differs, or
    None: where to look when their bytes differ."""
    import dataclasses
    from plonkit_tpu_torch.plonk.extended import VerificationKey2
    a, b = VerificationKey2.load(path), VerificationKey2.load(want)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if va != vb:
            if isinstance(va, list) and len(va) == len(vb):
                i = next(i for i, (x, y) in enumerate(zip(va, vb)) if x != y)
                return f"{f.name}[{i}]: {va[i]} != {vb[i]}"
            return f"{f.name}: {va} != {vb}"
    return None


def phase_recursive_cli(tmp: str, key: str) -> None:
    """The 5 recursive subcommands on scratch/recursive_r5 (one proof, a 2^21
    domain): their outputs must be the fixture's bytes."""
    t_all = time.perf_counter()
    d = os.path.join(tmp, "recursive")
    os.makedirs(d)
    old_vk = os.path.join(AGG_FIXTURES, "vk.bin")
    with open(os.path.join(d, "old_proof_list.txt"), "w") as f:
        f.write(os.path.join(AGG_FIXTURES, "proof_0.bin") + "\n")
    s = cli_together(
        ("export-recursive-verification-key", ["export-recursive-verification-key", "-c", "1",
                                               "-i", "2", "-m", key, "-o", old_vk]),
        ("recursive-prove", ["recursive-prove", "-m", key, "-f", "old_proof_list.txt",
                             "-v", old_vk]), cwd=d)
    with open(os.path.join(d, "recursive_proof.bin"), "rb") as f:
        blob = _flip_outer_input(f.read())
    with open(os.path.join(d, "tampered.bin"), "wb") as f:
        f.write(blob)
    s.update(cli_together(
        ("recursive-verify", ["recursive-verify"]),
        ("recursive-verify tampered", ["recursive-verify", "-p", "tampered.bin"], 400 % 256),
        ("check-aggregation", ["check-aggregation", "-o", "old_proof_list.txt", "-v", old_vk]),
        ("generate-recursive-verifier", ["generate-recursive-verifier", "-o", old_vk,
                                         "-i", "2", "-s", "recursive_verifier.sol"]), cwd=d))
    same = {name: _same_file(os.path.join(d, name), os.path.join(AGG_FIXTURES, name))
            for name in ("recursive_vk.bin", "recursive_proof.bin", "recursive_verifier.sol")}
    emit({"phase": "recursive_cli", "domain": 1 << ONE_PROOF_LOG2, "identical_to_fixture": same,
          "seconds": {k: round(v, 3) for k, v in s.items()},
          "total_s": round(time.perf_counter() - t_all, 3)})
    if not all(same.values()):
        where = _first_vk2_difference(os.path.join(d, "recursive_vk.bin"),
                                      os.path.join(AGG_FIXTURES, "recursive_vk.bin"))
        raise AssertionError(f"recursive CLI outputs differ from the fixture's: {same}; "
                             f"first differing vk field: {where}")


def phase_recursive_vk_pair(tmp: str, key: str) -> str:
    """export-recursive-verification-key -c 2 -i 2 of scratch/recursive_r22's
    circuit, a CLI process: its recursive_vk.bin must equal the fixture's
    (the JAX package's, 2,307,899 gates, n = 2^22 - 1).  Returns its path."""
    d = os.path.join(tmp, "recursive_pair")
    os.makedirs(d)
    seconds = cli("export-recursive-verification-key", "-c", "2", "-i", "2", "-m", key,
                  "-o", os.path.join(FIXTURES, "vk.bin"), cwd=d)
    path = os.path.join(d, "recursive_vk.bin")
    want = os.path.join(FIXTURES, "recursive_vk.bin")
    where = _first_vk2_difference(path, want)
    emit({"phase": "recursive_vk_pair", "proofs": 2, "domain": 1 << PAIR_LOG2,
          "identical_to_fixture": _same_file(path, want), "first_difference": where,
          "seconds": round(seconds, 3)})
    if not _same_file(path, want):
        raise AssertionError(f"the two-proof recursive vk differs from the fixture's: {where}")
    return path


def phase_recursive_vk_agg(tmp: str, key: str) -> str:
    """export-recursive-verification-key -c 5 -i 2 of scratch/recursive_r22's
    circuit, a CLI process: the vk of phase 10's five-proof aggregate at a
    2^23 domain (no reference file: neither package had made one).
    Returns its path."""
    from plonkit_tpu_torch.plonk.extended import VerificationKey2
    d = os.path.join(tmp, "recursive_agg")
    os.makedirs(d)
    peak_rss = [0]
    seconds = cli("export-recursive-verification-key", "-c", str(AGG_PROOFS), "-i", "2",
                  "-m", key, "-o", os.path.join(FIXTURES, "vk.bin"), cwd=d, peak_rss=peak_rss)
    path = os.path.join(d, "recursive_vk.bin")
    rec_vk = VerificationKey2.load(path)
    emit({"phase": "recursive_vk_agg", "proofs": AGG_PROOFS, "domain": rec_vk.n + 1,
          "num_inputs": rec_vk.num_inputs, "seconds": round(seconds, 3),
          "peak_rss_bytes": peak_rss[0]})
    if rec_vk.n + 1 != 1 << AGG_LOG2 or rec_vk.num_inputs != 1:
        raise AssertionError(f"the {AGG_PROOFS}-proof recursive vk: n {rec_vk.n}, "
                             f"{rec_vk.num_inputs} inputs")
    return path


@contextlib.contextmanager
def _port_log(found: list):
    """Append (message, torch.cuda.max_memory_allocated() then) for every
    INFO record of the port's logger (the aggregation circuit's gate count,
    each stage's end) to `found`: the first record that sees the final
    peak ends the stage that reached it."""
    import logging
    import torch

    class Found(logging.Handler):
        def emit(self, record):
            found.append((record.getMessage(), torch.cuda.max_memory_allocated()))

    logger, handler = logging.getLogger("plonkit_tpu_torch"), Found()
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


@contextlib.contextmanager
def _transforms_by_size(split: dict, engine: dict):
    """Count TorchBackend's transforms for the block: each split coset
    transform into `split` and each call of an NTT engine (a split
    transform's parts and every monolithic transform) into `engine`, by
    "op 2^k" with k the log2 of the points it computes."""
    from plonkit_tpu_torch import backend_torch
    from plonkit_tpu_torch.backend_torch import TorchBackend

    def label(op, points):
        return f"{op} 2^{points.bit_length() - 1}"

    def counted_engine(op, n, device):
        engine[label(op, n)] = engine.get(label(op, n), 0) + 1
        return real_engine(op, n, device)

    def counted(op, real):
        def run(self, v, factor, shift):
            points = len(v) * (factor if op == "coset_lde" else 1)
            split[label(op, points)] = split.get(label(op, points), 0) + 1
            return real(self, v, factor, shift)
        return run

    real_engine = backend_torch._engine
    reals = {op: getattr(TorchBackend, f"_{op}_split")
             for op in ("coset_ntt", "coset_lde", "coset_intt")}
    backend_torch._engine = counted_engine
    for op, real in reals.items():
        setattr(TorchBackend, f"_{op}_split", counted(op, real))
    try:
        yield
    finally:
        backend_torch._engine = real_engine
        for op, real in reals.items():
            setattr(TorchBackend, f"_{op}_split", real)


def _max_rss_bytes() -> int:
    """This process's peak RSS in bytes (ru_maxrss: kilobytes on Linux)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _commit_ms(key: str) -> dict:
    """Device ms a commitment (gpu/msm.py over the SRS prefix, one random
    vector) at 2^22 and 2^23 points: CUDA events over 3 msm_vec calls."""
    import torch
    from plonkit_tpu_torch.backend_torch import TorchBackend
    from plonkit_tpu_torch.gpu.mont import to_tensor
    from plonkit_tpu_torch.serialization import CrsHandle
    rng = np.random.default_rng(SEED + 11)
    out = {}
    for k in (PAIR_LOG2, AGG_LOG2):
        ctx = TorchBackend(DEVICE).device_msm_context(CrsHandle(key), 1 << k)
        v = to_tensor(_random_fr_rows(rng, 1 << k), DEVICE)
        out[f"2^{k}"] = time_ms(lambda: ctx.msm_vec(v), 3)
        del ctx, v
        torch.cuda.empty_cache()
    return out


def phase_recursive(tmp: str, key: str, rec_vk_path):
    """prove_aggregation of five proofs at a 2^23 domain in this process
    under torch.profiler (scratch/recursive_r22's proof_0.bin and
    proof_1.bin, made by the JAX package, and phase 7's proof_2.bin ...
    proof_4.bin), while the CLI processes of phases 7-9 run: the gate
    count, launches of every kernel from 0, stage times, peak device
    memory and the stage that reached it, peak host RSS, device busy time
    and idle share, and the transforms by size: every 2^25-point coset
    transform must take the split path (four 2^23-point parts), none run
    whole.  Then, once phase 9's five-proof vk (the future `rec_vk_path`)
    is there, verify_aggregation with it (and a tampered copy) and
    check_aggregation; recursive_proof.bin through the CLI:
    recursive-verify (0, and 144 on a tampered copy) and check-aggregation
    with the five-line proof list; and the device ms a commitment at 2^22
    and 2^23.  Returns the launches and the aggregate."""
    import torch
    from plonkit_tpu_torch import profiling
    from plonkit_tpu_torch.backend_torch import TorchBackend
    from plonkit_tpu_torch.plonk.extended import VerificationKey2
    from plonkit_tpu_torch.recursive.aggregation import (AggregatedProof, check_aggregation,
                                                         prove_aggregation, verify_aggregation)
    from plonkit_tpu_torch.serialization import CrsHandle, Proof, VerificationKey
    vk = VerificationKey.load(os.path.join(FIXTURES, "vk.bin"))
    paths = ([os.path.join(FIXTURES, f"proof_{i}.bin") for i in (0, 1)]
             + [inner_proof_path(tmp, i) for i in INNER])
    proofs = [Proof.load(p) for p in paths]
    backend = TorchBackend(DEVICE)
    crs = CrsHandle(key)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    profiling.reset()
    logged, split, engine = [], {}, {}
    rss_before = _max_rss_bytes()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with _port_log(logged), _transforms_by_size(split, engine), \
            torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        agg = prove_aggregation(crs, proofs, vk, backend=backend)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rss = _max_rss_bytes()
    stages = dict(profiling.last_timings)
    kernels, busy, by_kernel = device_activity(prof)
    events = len(kernels)
    del prof, kernels
    gates = [int(m.group(1)) for m in map(re.compile(r"aggregation circuit: (\d+) gates").match,
                                           (ln for ln, _ in logged)) if m]
    steps = [(" ".join(ln.split()), at) for ln, at in logged if ln.startswith("[stage] ")]
    reached = next((i for i, (_, at) in enumerate(steps) if at == peak), None)
    whole = {k: c for k, c in engine.items() if int(k.rsplit("^", 1)[1]) >= AGG_LOG2 + 2}
    t_vk = time.perf_counter()
    rec_vk_path = rec_vk_path.result()
    vk_wait = time.perf_counter() - t_vk
    t0 = time.perf_counter()
    rec_vk = VerificationKey2.load(rec_vk_path)
    d = os.path.dirname(rec_vk_path)
    agg.save(os.path.join(d, "recursive_proof.bin"))
    with open(os.path.join(d, "recursive_proof.bin"), "rb") as f:
        blob = _flip_outer_input(f.read())
    with open(os.path.join(d, "tampered.bin"), "wb") as f:
        f.write(blob)
    with open(os.path.join(d, "old_proof_list.txt"), "w") as f:
        f.write("".join(p + "\n" for p in paths))
    tampered = AggregatedProof.read(io.BytesIO(blob))
    with ThreadPoolExecutor(1) as pool:     # the CLI's checks beside this process's
        cli_run = pool.submit(
            cli_together,
            ("recursive-verify", ["recursive-verify", "-p", "recursive_proof.bin"]),
            ("recursive-verify tampered", ["recursive-verify", "-p", "tampered.bin"], 400 % 256),
            ("check-aggregation", ["check-aggregation", "-o", "old_proof_list.txt",
                                   "-v", os.path.join(FIXTURES, "vk.bin")]), cwd=d)
        lde, intt = f"coset_lde 2^{AGG_LOG2 + 2}", f"coset_intt 2^{AGG_LOG2 + 2}"
        checks = {"num_gates": gates == [AGG_GATES],
                  "verify_aggregation": verify_aggregation(rec_vk, agg, vk),
                  "tampered_rejected": not verify_aggregation(rec_vk, tampered, vk),
                  "check_aggregation": check_aggregation(vk, proofs, agg),
                  f"domain_2pow{AGG_LOG2}": agg.proof.n + 1 == 1 << AGG_LOG2,
                  "individual_inputs": len(agg.individual_inputs) == AGG_PROOFS * vk.num_inputs,
                  f"split {lde} and {intt}": split.get(lde, 0) > 0 and split.get(intt, 0) > 0,
                  "no whole transform of 2^25 points or more": not whole}
        check_s = time.perf_counter() - t0
        cli_s = cli_run.result()
    commit_ms = _commit_ms(key)
    emit({"phase": "recursive", "proofs": len(proofs), "num_gates": gates[-1] if gates else None,
          "domain": agg.proof.n + 1, "n": agg.proof.n, "checks": checks,
          "split_transforms": split, "engine_transforms": engine,
          "vk_wait_s": round(vk_wait, 3), "check_s": round(check_s, 3),
          "cli_exit_codes": {"recursive-verify": 0, "recursive-verify tampered": 400 % 256,
                             "check-aggregation": 0},
          "cli_s": {k: round(v, 3) for k, v in cli_s.items()},
          "prove_aggregation_s": wall, "stages_s": {k: round(v, 3) for k, v in stages.items()},
          "launches": launches, "max_memory_allocated_bytes": peak,
          "peak_by_step": [f"{ln}: peak {at}" for ln, at in steps],
          "peak_reached_after": steps[reached - 1][0] if reached else None,
          "peak_reached_by": steps[reached][0] if reached is not None else None,
          "max_rss_bytes": {"before the prove": rss_before, "after the prove": rss},
          "device_events": events,
          "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
          "commit_ms": commit_ms, "by_kernel": by_kernel})
    if not all(checks.values()):
        raise AssertionError(f"the {AGG_PROOFS}-proof aggregate at 2^{AGG_LOG2} fails: {checks}; "
                             f"split {split}, engine {engine}")
    # on the card the tensor cores take every transform of 512 points or
    # more: the butterflies, left with the smaller ones, may idle
    idle = [k for k, v in launches.items() if v == 0 and k not in BUTTERFLIES + GROUP_NTT]
    if idle:
        raise AssertionError(f"kernels never launched on the recursive path: {idle}")
    return launches, agg


def phase_split_ntt() -> None:
    """The 2^24-point coset LDE of one random 2^22-point vector, its coset
    iNTT, and the 2^24-point coset NTT of that LDE, through TorchBackend's
    split transforms (the path of a 2^22 domain) and through the monolithic
    ones (SPLIT_NTT_MIN raised in this process), under each NTT engine:
    equal bit for bit, the iNTT gives the vector back, and the engines'
    results are equal."""
    import torch
    from plonkit_tpu_torch import backend_torch
    from plonkit_tpu_torch.backend_torch import FrVec, TorchBackend
    from plonkit_tpu_torch.gpu.mont import to_tensor
    t_all = time.perf_counter()
    n = 1 << PAIR_LOG2
    if n * SPLIT_FACTOR < backend_torch.SPLIT_NTT_MIN:
        raise AssertionError("a 2^22 domain no longer reaches the split transforms")
    b = TorchBackend(DEVICE)
    v = FrVec(to_tensor(_random_fr_rows(np.random.default_rng(SEED + 3), n, 0), DEVICE))
    same, ms, split = {}, {}, {}
    for engine in ("auto", "pease"):
        lde, ms[engine] = {}, {}
        with _ntt_engine(engine):
            for route, threshold in (("split", backend_torch.SPLIT_NTT_MIN),
                                     ("monolithic", 1 << 62)):
                saved, backend_torch.SPLIT_NTT_MIN = backend_torch.SPLIT_NTT_MIN, threshold
                try:       # each timed after one untimed call (the tables of its size)
                    b.coset_lde(v, SPLIT_FACTOR)
                    lde[route], ms[engine][f"coset_lde {route}"] = _timed_once(
                        lambda: b.coset_lde(v, SPLIT_FACTOR))
                    b.coset_intt(lde["split"])
                    lde[f"{route} intt"], ms[engine][f"coset_intt {route}"] = _timed_once(
                        lambda: b.coset_intt(lde["split"]))
                    b.coset_ntt(lde["split"])
                    lde[f"{route} ntt"], ms[engine][f"coset_ntt {route}"] = _timed_once(
                        lambda: b.coset_ntt(lde["split"]))
                finally:
                    backend_torch.SPLIT_NTT_MIN = saved
        back = lde["split intt"].data
        same[engine] = {
            "coset_lde": torch.equal(lde["split"].data, lde["monolithic"].data),
            "coset_intt": torch.equal(back, lde["monolithic intt"].data),
            "coset_ntt": torch.equal(lde["split ntt"].data, lde["monolithic ntt"].data),
            "round_trip": torch.equal(back[:n], v.data) and not bool(back[n:].any())}
        split[engine] = [lde[k].data for k in ("split", "split intt", "split ntt")]
        del lde, back
        torch.cuda.empty_cache()
    same["engines agree"] = {"split " + op: torch.equal(x, y) for op, x, y in
                             zip(("coset_lde", "coset_intt", "coset_ntt"), *split.values())}
    emit({"phase": "split_ntt", "points": n, "lde_points": n * SPLIT_FACTOR, "identical": same,
          "ms": ms, "seconds": round(time.perf_counter() - t_all, 3)})
    if not all(ok for checks in same.values() for ok in checks.values()):
        raise AssertionError(f"split and monolithic coset transforms differ: {same}")


def phase_ntt_engines() -> None:
    """Both NTT engines on the card on the same random canonical vectors:
    ntt and intt at 2^20, the coset LDE x4 of a 2^20 vector, coset_ntt and
    coset_intt at 2^22, a monolithic 2^24 coset_ntt, and ntt at the
    smaller sizes SWEEP_NTT_LOG2 (where auto's threshold of 512 points
    lies).  Each transform is warmed once (its tables), then run once with
    the launches counted and timed over more calls (CUDA events: 3 from
    2^20 on, 20 below).  The engines must agree bit for bit, and each
    inverse must give its vector back."""
    import torch
    from plonkit_tpu_torch.gpu import ntt as gntt, ntt_mxu as gmxu
    from plonkit_tpu_torch.gpu.mont import to_tensor
    t_all = time.perf_counter()
    rng = np.random.default_rng(SEED + 6)
    a, b, c = MAIN_LOG2, PAIR_LOG2, PAIR_LOG2 + 2      # 2^20, 2^22, 2^24
    v = {k: to_tensor(_random_fr_rows(rng, 1 << k, 0), DEVICE)
         for k in (a, b, c) + SWEEP_NTT_LOG2}
    engines = {"pease": lambda op: getattr(gntt, op),
               "mxu": lambda op: getattr(gmxu, op + "_mxu")}
    out, report = {}, {}
    for engine, fn in engines.items():
        res = out[engine] = {}
        cases = ((f"ntt 2^{a}", lambda: fn("ntt")(v[a])),
                 (f"intt 2^{a}", lambda: fn("intt")(res[f"ntt 2^{a}"])),
                 (f"coset_lde x4 of 2^{a}", lambda: fn("coset_lde")(v[a], 4)),
                 (f"coset_ntt 2^{b}", lambda: fn("coset_ntt")(v[b])),
                 (f"coset_intt 2^{b}", lambda: fn("coset_intt")(res[f"coset_ntt 2^{b}"])),
                 (f"coset_ntt 2^{c}", lambda: fn("coset_ntt")(v[c])))
        small = tuple((f"ntt 2^{k}", lambda k=k: fn("ntt")(v[k])) for k in SWEEP_NTT_LOG2)
        for label, call in cases + small:
            call()
            _reset_launches()
            res[label], _ = _timed_once(call)
            launched = {k: c for k, c in _launch_counts().items() if c}
            reps = 20 if (label, call) in small else 3
            report.setdefault(label, {})[engine] = {"ms": time_ms(call, reps),
                                                    "launches": launched}
        torch.cuda.empty_cache()
    same = {label: torch.equal(out["pease"][label], out["mxu"][label]) for label in report}
    back = {f"{e} {label}": torch.equal(out[e][label], v[k]) for e in engines
            for label, k in ((f"intt 2^{a}", a), (f"coset_intt 2^{b}", b))}
    faster = [label for label, r in report.items() if r["mxu"]["ms"] < r["pease"]["ms"]]
    emit({"phase": "ntt_engines", "identical": same, "inverse_gives_the_vector": back,
          "by_transform": report, "mxu_takes_less_time": faster,
          "seconds": round(time.perf_counter() - t_all, 3)})
    if not all(same.values()) or not all(back.values()):
        raise AssertionError(f"the NTT engines disagree: {same}, round trips {back}")


def phase_contract(tmp: str, agg, rec_vk_path: str) -> None:
    """The rendered verifiers in the port's interpreter on the card's
    proofs: each must accept its proof and reject every tampered copy
    (contract.py raises otherwise).  The recursive verifier rendered for
    one proof's inputs, as generate-recursive-verifier -i 2 renders it,
    must revert "bad input count" on the five-proof aggregate."""
    from plonkit_tpu_torch import contract, solvm
    from plonkit_tpu_torch.plonk.extended import VerificationKey2
    from plonkit_tpu_torch.serialization import VerificationKey
    from plonkit_tpu_torch.solidity import render_recursive_verification_key
    t_all = time.perf_counter()
    d = os.path.join(tmp, "contract")
    os.makedirs(d)
    vk = VerificationKey.load(os.path.join(FIXTURES, "vk.bin"))
    rec_vk = VerificationKey2.load(rec_vk_path)
    # INDIVIDUAL_INPUTS is the count of every proof's inputs together: 10
    agg_sol = os.path.join(d, "recursive_verifier.sol")
    with open(agg_sol, "w") as f:
        f.write(render_recursive_verification_key(vk, rec_vk, len(agg.individual_inputs)))
    agg_json = os.path.join(d, "recursive_proof.json")
    with open(agg_json, "w") as f:
        json.dump(agg.solidity_json(), f, indent=1)
    cli64, rec = os.path.join(tmp, "cli64"), os.path.join(tmp, "recursive")
    jobs = {
        "verifier.sol, domain 64 (phase 7)": lambda: contract.run_single(
            os.path.join(cli64, "verifier.sol"), os.path.join(cli64, "proof.json"),
            os.path.join(cli64, "public.json")),
        "recursive_verifier.sol, one proof at 2^21 (phase 9)": lambda: contract.run_recursive(
            os.path.join(rec, "recursive_verifier.sol"),
            os.path.join(rec, "recursive_proof.json")),
        f"recursive verifier, {AGG_PROOFS} proofs at 2^{AGG_LOG2} (phase 10)": lambda:
            contract.run_recursive(agg_sol, agg_json),
    }
    found, seconds = {}, {}
    for name, job in jobs.items():
        t0 = time.perf_counter()
        found[name] = job()
        seconds[name] = round(time.perf_counter() - t0, 3)
    # generate-recursive-verifier -i 2 renders one proof's input count: a
    # contract that cannot take the five proofs' 10 inputs
    per_proof = solvm.Interpreter(render_recursive_verification_key(vk, rec_vk, vk.num_inputs))
    try:
        per_proof_out = "returned %d" % per_proof.call(
            "verifyAggregatedProof", *contract.recursive_arguments(agg.solidity_json()))
    except solvm.SolRevert as e:
        per_proof_out = f"reverted: {e}"
    emit({"phase": "contract", "runs": found, "seconds": seconds,
          "individual_inputs": len(agg.individual_inputs),
          "aggregate_with_one_proof_input_count": per_proof_out,
          "total_s": round(time.perf_counter() - t_all, 3)})
    if "bad input count" not in per_proof_out:
        raise AssertionError(f"the one-proof verifier on {AGG_PROOFS} proofs: {per_proof_out}")


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
    kernels, busy, by_kernel = device_activity(prof)
    emit({"phase": "profile", "prove_wall_s": wall, "device_events": len(kernels),
          "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
          "msm_s": profiling.last_timings.get("msm", 0.0),
          "stages_s": {k: round(v, 3) for k, v in profiling.last_timings.items()},
          "by_kernel": by_kernel})


def device_activity(prof, top: int = 24):
    """A torch.profiler run's device events, their busy seconds (the union
    of their intervals) and the `top` kernel names by device time."""
    import torch
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device activity")
    by_name = {}
    for e in kernels:
        rec = by_name.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.end - e.time_range.start
    busy = merged_busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return kernels, busy, [{"name": n[:80], "count": c, "ms": t / 1e3}
                           for n, (c, t) in ranked]


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
    with tempfile.TemporaryDirectory(prefix="plonkit_smoke_") as tmp, \
            ThreadPoolExecutor(len(INNER) + 1) as cpu_pool:
        key, launches_srs = phase_srs(tmp)
        cpu_calls = start_cpu_calls(tmp, key, cpu_pool)
        handle = CrsHandle(key)
        ctx = TorchBackend(DEVICE).device_msm_context(handle, 1 << MAIN_LOG2)
        rows = phase_kernels(ctx)
        phase_msm(ctx, HostMSMContext.from_limbs(*handle.g1_limbs(1 << MAIN_LOG2)))
        del ctx
        phase_cross_check(tmp)
        launches, launches_pease, circuit, vk_bytes, proof_bytes, setup = phase_main(key)
        launches_lagrange, lagrange_sha256 = phase_lagrange(setup, circuit, key, tmp,
                                                            proof_bytes)
        del setup
        torch.cuda.empty_cache()
        built = _build_snapshot()
        # phases 7, 8 and 9 in CLI processes; once phase 7 has proved the
        # inner proofs, phase 10 proves their aggregate in this process
        with ThreadPoolExecutor(5) as pool:
            full = pool.submit(phase_cli_full, tmp, key, circuit, vk_bytes, proof_bytes,
                               lagrange_sha256)
            rec = pool.submit(phase_recursive_cli, tmp, key)
            pair_vk = pool.submit(phase_recursive_vk_pair, tmp, key)
            agg_vk = pool.submit(phase_recursive_vk_agg, tmp, key)
            cli64 = pool.submit(phase_cli, tmp, phase_inner_proofs(tmp), cpu_calls)
            launches_recursive, agg = phase_recursive(tmp, key, agg_vk)
            for phase in (cli64, full, rec, pair_vk):
                phase.result()
        if _build_snapshot() != built:
            raise AssertionError("a CLI process rebuilt a kernel library")
        del circuit
        torch.cuda.empty_cache()
        phase_split_ntt()
        torch.cuda.empty_cache()
        phase_ntt_engines()
        torch.cuda.empty_cache()
        pos_setup, pos_circuit, pos_vk, pos_proof = phase_poseidon(tmp, key)
        launches_mesh = phase_mesh(pos_setup, pos_circuit, pos_vk, pos_proof)
        del pos_setup, pos_circuit
        torch.cuda.empty_cache()
        phase_mesh_ranks(tmp, key)
        phase_contract(tmp, agg, agg_vk.result())
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["launches_pease_prove"] = launches_pease[r["name"]]
        r["launches_recursive"] = launches_recursive[r["name"]]
        r["launches_srs"] = launches_srs[r["name"]]
        r["launches_mesh"] = launches_mesh[r["name"]]
        r["launches_lagrange"] = launches_lagrange[r["name"]]
    emit({"kernels": rows})
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 3)})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
