"""The general generator: what every kind of traffic shares.  A traffic
mix's data file names its `kind`, and the kind is the file
portbench/kinds/<kind>.py; a configuration names its `circuit`, the file
portbench/circuits/<circuit>.py; a metric is portbench/metrics/<name>.py.
Each is found by name with `load`, so a new one is a new file.

A kind's file defines `Work(config, traffic, seed, device, control)` with
`setup()` (every input from the seed, the cell's own shapes warmed),
`request(i)` (the entry point the window drives, once), `keep(i, answer)`
(what the judge will read of the answer, or None: answers it will not read
are dropped as they come), `release()` (the program's state freed) and
`judge(kept)` -> ({number: (value, limit)}, answers refused).  `control`
switches on the program's own path that breaks one guarantee of the
configuration; the kind's file says which."""

import gc
import importlib.util
import os
import random
import sys
import time
from contextlib import nullcontext

from .reference import bn254

HERE = os.path.dirname(os.path.abspath(__file__))


def load(folder: str, name: str):
    """The module portbench/<folder>/<name>.py."""
    key = f"portbench_{folder}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    path = os.path.join(HERE, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not os.path.isfile(path):
        raise FileNotFoundError(f"no {folder} file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def drawn(seed: int, index: int, every: int) -> bool:
    """Whether request `index` of a run seeded with `seed` is judged: the
    first, and one in `every` of the others on average, drawn from the
    seed, so the judge's sample is fixed before the window opens."""
    return every <= 1 or index == 0 or \
        random.Random(f"portbench:drawn:{seed}:{index}").randrange(every) == 0


def seeded_tau(seed: int, index: int) -> int:
    return random.Random(f"portbench:tau:{seed}:{index}").randrange(2, bn254.R)


def device_key(log2: int, tau: int, device: str):
    """The monomial key tau^i G, i < 2^log2, made on the device."""
    from plonkit_tpu_torch.curve import G2_GEN, g2_mul
    from plonkit_tpu_torch.gpu.fixed_base import gen_crs_g1_device
    from plonkit_tpu_torch.serialization import CrsLimbs
    x, y, inf = gen_crs_g1_device(log2, tau, device)
    return CrsLimbs(x, y, inf, [G2_GEN, g2_mul(G2_GEN, tau)])


def free(device: str) -> None:
    gc.collect()
    if device != "cpu":
        import torch
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def window(work, seconds: float, around=None):
    """Requests in turn until `seconds` have passed since the first began;
    the window closes when the last one ends.  `around(i)`, if given, is a
    context manager around request i.  Returns (kept [(index, what
    work.keep kept)], requests completed, host seconds of each request,
    errors, the window's length)."""
    kept, times, errors = [], [], []
    completed = 0
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        s = time.perf_counter()
        try:
            with around(i) if around is not None else nullcontext():
                answer = work.request(i)
            completed += 1
            k = work.keep(i, answer)
            del answer
            if k is not None:
                kept.append((i, k))
        except Exception as e:               # a request that fails is counted, not fatal
            errors.append(f"request {i}: {type(e).__name__}: {e}")
        times.append(time.perf_counter() - s)
        i += 1
    return kept, completed, times, errors, time.perf_counter() - t0
