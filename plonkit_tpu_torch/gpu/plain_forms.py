"""The two forms of gpu/mont.py's plain field ops, timed side by side.

    python -m plonkit_tpu_torch.gpu.plain_forms [--device cuda] [--min-log2 8] [--max-log2 20]
                                                [--lanes-log2 12]

For 2^min, 2^(min + 2), ... 2^max rows of Fq: mont_mul, add and sub in the limb
loop and in the vectorised form, each over a few calls after a warm-up
(their mean by CUDA events on the card, their median by the host clock on
the CPU, whose calls other work on the host can stretch).  Then one
plain K15 ladder (group_ntt.g1_scale_plain by 1/2^20, as chip_smoke.py
checks K15) on 2^lanes points in each form, both forms held equal.
Prints one JSON line a size and one for the ladder, in ms.  mont.VEC_ROWS,
the rows up to which the vectorised form runs, is read from these lines.
Needs no kernel and no nvcc.
"""

import argparse
import json
import time

import numpy as np
import torch

from ..curve import G1_GEN, g1_add
from ..fields import fr_inv
from . import ec, group_ntt, mont
from .mont import FQ, to_tensor

FORMS = {"loop": 0, "vectorised": 1 << 62}      # VEC_ROWS for each form


def _timed(fn, device: str, reps: int) -> float:
    fn()
    if device == "cuda":
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def _in_form(form: str, device: str, fn):
    saved = mont.VEC_ROWS[device]
    mont.VEC_ROWS[device] = FORMS[form]
    try:
        return fn()
    finally:
        mont.VEC_ROWS[device] = saved


def field_ops(device: str, log2: int, rng) -> dict:
    n = 1 << log2
    a, b = (to_tensor(FQ.to_limbs_np([int.from_bytes(rng.bytes(32), "little") % FQ.p
                                      for _ in range(n)]), device) for _ in range(2))
    out = {"rows": n}
    for op in ("mont_mul", "add", "sub"):
        fn = getattr(mont, op)
        results = {}
        for form in FORMS:
            out[f"{op} {form}"] = _in_form(form, device,
                                           lambda: _timed(lambda: fn(FQ, a, b), device, 5))
            results[form] = _in_form(form, device, lambda: fn(FQ, a, b))
        if not torch.equal(results["loop"], results["vectorised"]):
            raise AssertionError(f"{op}: the two forms differ at {n} rows")
    return out


def ladder(device: str, log2: int) -> dict:
    """g1_scale_plain by 1/2^20 on the points G, 2G, ... (2^log2 of them)."""
    pts, acc = [], G1_GEN
    for _ in range(1 << log2):
        pts.append(acc)
        acc = g1_add(acc, G1_GEN)
    p = ec.jacobian_from_affine(ec.affine_from_host(pts, device))
    s = fr_inv(1 << 20)
    out, results = {"lanes": 1 << log2}, {}
    for form in FORMS:
        out[f"g1_scale_plain {form}"] = _in_form(
            form, device, lambda: _timed(lambda: group_ntt.g1_scale_plain(p, s), device, 1))
        results[form] = _in_form(form, device, lambda: group_ntt.g1_scale_plain(p, s))
    if not all(torch.equal(x, y) for x, y in zip(results["loop"], results["vectorised"])):
        raise AssertionError("g1_scale_plain: the two forms differ")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--min-log2", type=int, default=8)
    ap.add_argument("--max-log2", type=int, default=20)
    ap.add_argument("--lanes-log2", type=int, default=12)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    rng = np.random.default_rng(0)
    for log2 in range(args.min_log2, args.max_log2 + 1, 2):
        print(json.dumps(field_ops(args.device, log2, rng)), flush=True)
    print(json.dumps(ladder(args.device, args.lanes_log2)), flush=True)


if __name__ == "__main__":
    main()
