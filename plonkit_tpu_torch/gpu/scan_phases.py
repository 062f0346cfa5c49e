"""Where the time of K12 field_scan goes on the card, tile by tile.

    python -m plonkit_tpu_torch.gpu.scan_phases     # needs a CUDA device and nvcc

Builds csrc/scan.cu with PLONKIT_SCAN_TRACE defined into
plonkit_tpu_torch/build/ (libscan_trace-<hash>.so, beside the untraced
library), runs the main path's two scans at 2^20 rows through it (the
grand product's Fr exclusive prefix product and divide_by_linear's Fr
exclusive suffix sum), holds each against field_kernels.scan_plain, and
prints one JSON line each: the span of the kernel from the global timer,
the tiles, the most tiles one SM took, and each phase's mean and max over
the tiles in microseconds: `reduce` (the tile index, the thread's rows
read and reduced), `scans` (the warp's and the block's scans, the
aggregate published), `look_back`, `apply` (the rows read again, the
prefix applied, the rows stored).  Launches here do not count in
field_kernels.launches.
"""

import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

from . import build, field_kernels as fk
from .mont import FR, to_tensor

PHASES = ("reduce", "scans", "look_back", "apply")
LOG2 = 20


def traced_library() -> ctypes.CDLL:
    flags = build.NVCC_FLAGS + ["-DPLONKIT_SCAN_TRACE"]
    h = hashlib.sha256(" ".join(flags).encode())
    for fname in ("scan.cu", "field.cuh"):
        with open(os.path.join(build.CSRC, fname), "rb") as f:
            h.update(f.read())
    path = os.path.join(build.BUILD_DIR, f"libscan_trace-{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        subprocess.run([build._nvcc(), *flags, "-o", tmp, os.path.join(build.CSRC, "scan.cu")],
                       check=True, capture_output=True)
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.plonkit_field_scan.argtypes = build._ARGTYPES["scan"]["plonkit_field_scan"]
    lib.plonkit_field_scan.restype = ctypes.c_int
    lib.plonkit_scan_trace.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.plonkit_scan_trace.restype = ctypes.c_int
    return lib


def traced_scan(lib, x: torch.Tensor, op: str, reverse: bool, exclusive: bool):
    """One traced launch: (the scan, [tiles, 6] trace)."""
    n = x.shape[0]
    tiles = -(-n // fk.SCAN_TILE)
    out = torch.empty_like(x)
    scratch = torch.empty(17 * tiles + 1, dtype=torch.int32, device=x.device)
    flags = (fk._REVERSE if reverse else 0) | (fk._EXCLUSIVE if exclusive else 0)
    build.check(lib.plonkit_field_scan(x.data_ptr(), out.data_ptr(), None, None,
                                       scratch.data_ptr(), scratch.numel(), n, FR.kernel_id,
                                       fk._SCAN_OPS[op], flags, fk.stream_ptr(x)),
                "K12 field_scan (traced)")
    torch.cuda.synchronize()
    trace = np.zeros((tiles, 6), dtype=np.uint64)
    build.check(lib.plonkit_scan_trace(trace.ctypes.data, tiles), "scan trace")
    return out, trace.astype(np.int64)


def summary(trace: np.ndarray) -> dict:
    ns = trace[:, :5] - trace[:, 0].min()
    spans = np.diff(ns, axis=1) / 1e3
    return {"kernel_us": float(ns[:, 4].max() / 1e3), "tiles": int(trace.shape[0]),
            "most_tiles_an_sm": int(np.bincount(trace[:, 5]).max()),
            "last_tile_start_us": float(ns[:, 0].max() / 1e3),
            "phases_us": {p: {"mean": float(spans[:, i].mean()), "max": float(spans[:, i].max())}
                          for i, p in enumerate(PHASES)}}


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_phases: no CUDA device", file=sys.stderr)
        return 2
    lib = traced_library()
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 1 << 32, size=(1 << LOG2, 8), dtype=np.uint64).astype(np.uint32)
    rows[:, 7] %= np.uint32(FR.p32[7])
    x = to_tensor(rows, "cuda")
    for label, op, reverse in (("grand product: Fr exclusive prefix product", "mul", False),
                               ("divide_by_linear: Fr exclusive suffix sum", "add", True)):
        traced_scan(lib, x, op, reverse, True)           # warm-up
        out, trace = traced_scan(lib, x, op, reverse, True)
        same = bool(torch.equal(out, fk.scan_plain(FR, x, op, reverse, True)))
        print(json.dumps(dict(scan=label, rows=1 << LOG2, equal_to_plain=same,
                              card=torch.cuda.get_device_name(0), **summary(trace))), flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
