#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (plonkit_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py          # from the root of the repository

Phases, each printing a JSON line with its wall seconds:

1. build: the CUDA kernels (csrc/*.cu, one nvcc per source, all at once) and
   the native host library (native/bn254.cpp), then the card's name and
   power limit as nvidia-smi reports them;
2. kernels: K1 mul, K2a add, K2b sub and K3 butterfly_dif at 2^20 elements
   on the card against their plain PyTorch versions on the same inputs
   (random Montgomery-form Fr values from a fixed numpy seed, with 0, 1,
   p-1 and p-2 planted; K3 with a real stage's twiddles).  Integer
   arithmetic: the results must be equal bit for bit;
3. cross-check: a 2^10-domain synthetic prove on the card gives vk.bin and
   proof.bin bytes identical to the same prove on the CPU (plain versions);
4. main path at a 2^20 domain: the synthetic multiplication chain,
   SetupForProver, make_verification_key, prove, verify, through the
   entry points a user calls, with the launch count of every kernel read
   from that run alone.  The proof must verify and a tampered copy must
   not.  Commitments run in the native host Pippenger ("msm":
   "host-native"); the MSM kernels are the next slice.  A second prove on
   the same setup runs under torch.profiler: device time by kernel, and
   the device's busy time and idle share over that prove's wall time.

Then the kernels line, the card line, and as the last line
{"ok": true, "device": {...}}.  Any failure raises: the exit code is not 0
and no result line is printed.  Without a CUDA device it stops at once.
"""

import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 20240917
KERNEL_LOG2 = 20        # phase 2 width
CROSS_LOG2 = 10         # phase 3 domain
MAIN_LOG2 = 20          # phase 4 domain

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth,
# and 32-bit integer multiplies: 64 lanes per SM per clock on sm_90, half
# the 128 FP32 lanes behind the 67 TFLOP/s float32 figure (2 flops per
# FMA), so 67e12 / 4.
HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 67e12 / 4

# per element (per butterfly for K3): bytes moved, each input read once and
# each output written once, and 32-bit multiply instructions (the
# Montgomery product: 64 + 64 wide products of 2 instructions each, plus 8
# for m = t0 * n0)
MONT_MUL_OPS = 2 * (64 + 64) + 8
KERNELS = {
    "K1 mul": dict(source="plonkit_tpu_torch/csrc/field.cu",
                   replaces="plonkit_tpu/tpu/pallas_kernels.py:149",
                   bytes=3 * 32, ops=MONT_MUL_OPS),
    "K2a add": dict(source="plonkit_tpu_torch/csrc/field.cu",
                    replaces="plonkit_tpu/tpu/pallas_kernels.py:153",
                    bytes=3 * 32, ops=0),
    "K2b sub": dict(source="plonkit_tpu_torch/csrc/field.cu",
                    replaces="plonkit_tpu/tpu/pallas_kernels.py:157",
                    bytes=3 * 32, ops=0),
    "K3 butterfly_dif": dict(source="plonkit_tpu_torch/csrc/ntt.cu",
                             replaces="plonkit_tpu/tpu/pallas_kernels.py:169",
                             bytes=5 * 32, ops=MONT_MUL_OPS),
}


def emit(obj) -> None:
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
        regs = [ln.strip() for ln in rec["ptxas"].splitlines() if "registers" in ln]
        emit({"build": name, "nvcc_s": round(rec["seconds"], 3), "ptxas": regs})
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "kernels": [os.path.basename(build.library_path(n)) for n in build.SOURCES],
          "native": os.path.basename(native.library_path())})
    print(card_line(), flush=True)


def _random_fr_rows(rng, n: int, planted_at: int) -> np.ndarray:
    """[n, 8] uint32 rows of random values below p (top limb below p's),
    with 0, 1, p-1, p-2 planted from row `planted_at`."""
    from plonkit_tpu_torch.gpu.mont import FR
    rows = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    rows[:, 7] %= np.uint32(FR.p32[7])
    rows[planted_at:planted_at + 4] = FR.to_limbs_np([0, 1, FR.p - 1, FR.p - 2])
    return rows


def phase_kernels() -> list:
    import torch
    from plonkit_tpu_torch.fields import get_domain_omega
    from plonkit_tpu_torch.gpu import field_kernels as fk, mont, ntt
    from plonkit_tpu_torch.gpu.mont import FR, to_tensor
    t0 = time.perf_counter()
    n = 1 << KERNEL_LOG2
    rng = np.random.default_rng(SEED)
    a = to_tensor(_random_fr_rows(rng, n, 0), "cuda")
    b = to_tensor(_random_fr_rows(rng, n, n - 4), "cuda")
    # K3 on one stage of a 2^20-point NTT: lo/hi halves and the stage-1
    # twiddles w^(2 * (j >> 1))
    half = n // 2
    omega_pows = ntt.powers(get_domain_omega(n), half, "cuda")
    tw = omega_pows[::2][:half >> 1].repeat_interleave(2, dim=0)
    lo, hi = a[:half], a[half:]

    def plain_bfly():
        return mont.add(FR, lo, hi), mont.mont_mul(FR, tw, mont.sub(FR, lo, hi))

    cases = {
        "K1 mul": (lambda: fk.mul(FR, a, b), lambda: mont.mont_mul(FR, a, b), n),
        "K2a add": (lambda: fk.add(FR, a, b), lambda: mont.add(FR, a, b), n),
        "K2b sub": (lambda: fk.sub(FR, a, b), lambda: mont.sub(FR, a, b), n),
        "K3 butterfly_dif": (lambda: ntt.butterfly_dif(lo, hi, tw), plain_bfly, half),
    }
    rows = []
    for name, (kern, plain, count) in cases.items():
        got, want = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        mism = sum(int((g != w).any(dim=1).sum()) for g, w in zip(got, want))
        err = max(int(((g.to(torch.int64) & 0xFFFFFFFF) - (w.to(torch.int64) & 0xFFFFFFFF))
                      .abs().max()) for g, w in zip(got, want))
        spec = KERNELS[name]
        bytes_s = spec["bytes"] * count / HBM_BYTES_PER_S
        ops_s = spec["ops"] * count / INT32_MUL_PER_S
        rows.append({
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "elements": count,
            "mismatches": mism, "max_abs_err": err,
            "ms": time_ms(kern, 20), "plain_ms": time_ms(plain, 3),
            "bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "bound_bytes": spec["bytes"] * count, "bound_int32_muls": spec["ops"] * count,
            "bound_basis": "max(bytes / 3.35e12 B/s, int32 multiplies / 16.75e12 per s)",
            "library_ms": None,
        })
    emit({"phase": "kernels", "seconds": round(time.perf_counter() - t0, 3),
          "mismatches": {r["name"]: r["mismatches"] for r in rows}})
    bad = [r["name"] for r in rows if r["mismatches"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return rows


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
    circuit = synth_circuit(CROSS_LOG2 - 1)
    vk_gpu, proof_gpu = _prove_bytes(circuit, key, "cuda")
    vk_cpu, proof_cpu = _prove_bytes(circuit, key, "cpu")
    same = {"vk.bin": vk_gpu == vk_cpu, "proof.bin": proof_gpu == proof_cpu}
    emit({"phase": "cross_check", "domain": 1 << CROSS_LOG2, "identical": same,
          "seconds": round(time.perf_counter() - t0, 3)})
    if not all(same.values()):
        raise AssertionError("cuda and cpu proves differ at 2^10")


def phase_main(tmp: str) -> dict:
    from plonkit_tpu_torch import profiling
    from plonkit_tpu_torch.api import SetupForProver, gen_key_monomial_form, verify
    from plonkit_tpu_torch.curve import G1_GEN, g1_mul
    from plonkit_tpu_torch.frontend.synthetic import synth_circuit
    from plonkit_tpu_torch.gpu import field_kernels as fk, ntt
    from plonkit_tpu_torch.gpu.mont import FQ
    from plonkit_tpu_torch.serialization import CrsHandle, Proof, load_crs_g1_limbs
    t_all = time.perf_counter()
    times = {}

    t0 = time.perf_counter()
    circuit = synth_circuit(MAIN_LOG2 - 1)
    times["circuit"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    key = os.path.join(tmp, f"srs_2pow{MAIN_LOG2}.key")
    gen_key_monomial_form(MAIN_LOG2).save(key)
    x, y, inf = load_crs_g1_limbs(key, 2)
    pts = [None if inf[i] else (FQ.from_limbs_np(x[i:i + 1])[0], FQ.from_limbs_np(y[i:i + 1])[0])
           for i in range(2)]
    if pts != [G1_GEN, g1_mul(G1_GEN, 42)]:
        raise AssertionError("SRS points 0 and 1 are not G and 42*G")
    times["srs"] = time.perf_counter() - t0

    for counts in (fk.launches, ntt.launches):
        for k in counts:
            counts[k] = 0
    profiling.reset()

    t0 = time.perf_counter()
    setup = SetupForProver(circuit, CrsHandle(key))
    times["setup"] = time.perf_counter() - t0
    domain = setup.setup_polynomials.domain_size
    if domain != 1 << MAIN_LOG2:
        raise AssertionError(f"domain {domain}, expected 2^{MAIN_LOG2}")
    t0 = time.perf_counter()
    vk = setup.make_verification_key()
    times["vk"] = time.perf_counter() - t0
    msm_vk = profiling.last_timings.get("host msm", 0.0)
    t0 = time.perf_counter()
    proof = setup.prove(circuit)
    times["prove"] = time.perf_counter() - t0
    launches = {"K1 mul": fk.launches["mul"], "K2a add": fk.launches["add"],
                "K2b sub": fk.launches["sub"], "K3 butterfly_dif": ntt.launches["butterfly_dif"]}
    stages = dict(profiling.last_timings)

    t0 = time.perf_counter()
    ok = verify(vk, proof)
    tampered = Proof.read(io.BytesIO(proof.to_bytes()))
    tampered.wire_values_at_z[0] = (tampered.wire_values_at_z[0] + 1) % (1 << 253)
    rejected = not verify(vk, tampered)
    times["verify"] = time.perf_counter() - t0
    vk.save(os.path.join(tmp, "vk.bin"))
    proof.save(os.path.join(tmp, "proof.bin"))

    emit({"phase": "main", "domain": domain, "msm": "host-native",
          "verified": ok, "tampered_rejected": rejected,
          "seconds": {k: round(v, 3) for k, v in times.items()},
          "stages_s": {k: round(v, 3) for k, v in stages.items()},
          "host_msm_s": {"vk": round(msm_vk, 3),
                         "prove": round(stages.get("host msm", 0.0) - msm_vk, 3)},
          "launches": launches,
          "total_s": round(time.perf_counter() - t_all, 3)})
    if not ok or not rejected:
        raise AssertionError(f"verify: proof {ok}, tampered rejected {rejected}")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    profile_prove(setup, circuit, vk)
    return launches


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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    emit({"phase": "profile", "prove_wall_s": wall, "device_events": len(kernels),
          "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
          "host_msm_s": profiling.last_timings.get("host msm", 0.0),
          "stages_s": {k: round(v, 3) for k, v in profiling.last_timings.items()},
          "by_kernel": [{"name": n[:80], "count": c, "ms": t / 1e3} for n, (c, t) in top]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import plonkit_tpu_torch  # noqa: F401  (fails outside the repository)
    t0 = time.perf_counter()
    phase_build()
    rows = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="plonkit_smoke_") as tmp:
        phase_cross_check(tmp)
        launches = phase_main(tmp)
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
