"""The port's device mesh: a torch.distributed process group, one rank per
process and one shard per rank (plonkit_tpu/parallel/mesh.py: a 1-D jax
Mesh over the chips of one program).

JAX's SPMD partitioner writes a sharded program's communication itself;
PyTorch has none, so every operation that crosses a shard boundary calls
one of the collectives below, on [N, 8] int32 Montgomery rows (or small
int64 sums):

- `all_to_all`: block j of this rank's buffer to rank j (the transposes of
  the 4-step NTT, parallel/ntt.py);
- `all_gather`: every rank's buffer, in rank order (MSM window totals, the
  first rows of a rotation, gathered vectors);
- `exclusive_scan`: the combination, by a caller's field operation, of one
  row from each lower rank (the offsets of sharded prefix products);
- `any`: a logical or over the ranks.

Each counts its calls and the bytes this rank sends (`counts`).

Two placements of a vector of n rows, the JAX package's domain_sharding
and replicated (`Mesh.sharded`, `Mesh.block`): rank r holds rows
[r n/D, (r + 1) n/D) when n >= D and D divides n
(plonkit_tpu/parallel/backend_mesh.py `_place`), and all n rows otherwise.

Process groups: `make_mesh` joins the group of this process when there is
one (the ranks `run_ranks` spawns, or torchrun's environment), and makes a
world of one on a file:// store in a temp dir otherwise.  It
takes NCCL for a CUDA device and gloo for the CPU unless the caller names
the backend: gloo ranks can share one card (NCCL takes one rank per card).
ProcessGroupGloo takes CUDA tensors for every collective used here
(checked with torch 2.11 and CUDA 12.8 on an H100; it stages them
through host memory itself), so CUDA tensors go to the collectives as they
are, whatever the backend.
"""

import atexit
import os
import pickle
import shutil
import tempfile
import time
from datetime import timedelta
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class Mesh:
    """The ranks of this process's (default) group and its place in it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.counts = {op: {"calls": 0, "bytes": 0}
                       for op in ("all_to_all", "all_gather", "any")}

    def _count(self, op: str, t: torch.Tensor) -> None:
        self.counts[op]["calls"] += 1
        self.counts[op]["bytes"] += t.numel() * t.element_size()

    def reset_counts(self) -> None:
        for c in self.counts.values():
            c["calls"] = c["bytes"] = 0

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x: [D * b, ...] contiguous.  Block j of x goes to rank j; block j
        of the result came from rank j."""
        if x.shape[0] % self.size:
            raise ValueError(f"{x.shape[0]} rows do not split into {self.size} blocks")
        out = torch.empty_like(x)
        self._count("all_to_all", x)
        dist.all_to_all_single(out, x.contiguous())
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x (all of one shape), concatenated in rank order
        along the first axis."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._count("all_gather", x)
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    def exclusive_scan(self, row: torch.Tensor, op: Callable, identity: torch.Tensor):
        """op over the rows of the ranks below this one, in rank order,
        starting from `identity` (all [1, 8]): the exclusive prefix of one
        row per rank."""
        rows = self.all_gather(row)
        acc = identity
        for s in range(self.rank):
            acc = op(acc, rows[s:s + 1])
        return acc

    def any(self, flag: bool) -> bool:
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        self._count("any", t)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def sharded(self, n: int) -> bool:
        """Whether a vector of n rows is a domain shard (else replicated)."""
        return n >= self.size and n % self.size == 0

    def block(self, n: int):
        """The rows [start, stop) of a vector of n rows that this rank holds."""
        if not self.sharded(n):
            return 0, n
        b = n // self.size
        return self.rank * b, (self.rank + 1) * b


def _world_of_one(backend: str) -> None:
    store = tempfile.mkdtemp(prefix="plonkit_mesh_")
    atexit.register(shutil.rmtree, store, ignore_errors=True)
    dist.init_process_group(backend, init_method="file://" + os.path.join(store, "store"),
                            world_size=1, rank=0)
    atexit.register(dist.destroy_process_group)      # runs before the rmtree


def _card(device: torch.device, n_cards: int, local_rank=None) -> torch.device:
    """The card a process binds: the one `device` names, else that of its
    rank on this host (`local_rank`, else torchrun's LOCAL_RANK) modulo
    the n_cards, else the current one.  NCCL takes one rank per card."""
    if device.index is not None:
        return device
    if local_rank is None:
        local_rank = os.environ.get("LOCAL_RANK")
    if local_rank is None:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda", int(local_rank) % n_cards)


def make_mesh(device="cuda", backend: str = None) -> Mesh:
    """The mesh of this process's group on `device`: the group already
    initialised, torchrun's (env://), or a new world of one.  `backend`
    (nccl, gloo) is NCCL on a card and gloo on the CPU unless named; a
    group already initialised with another backend raises.  A "cuda"
    device without an index is the card of torchrun's LOCAL_RANK (modulo
    the cards), else the current one."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (the CPU mesh must be asked "
                               "for with device='cpu')")
        device = _card(device, torch.cuda.device_count())
        torch.cuda.set_device(device)
    want = backend or ("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
            dist.init_process_group(want, init_method="env://")
        else:
            _world_of_one(want)
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    return Mesh(device)


def _rank_entry(rank: int, n_ranks: int, device: str, backend: str, store: str,
                result: str, timeout_s: float, fn: Callable, args: tuple) -> None:
    device = torch.device(device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    else:          # NCCL ranks take a card each, gloo ranks share card 0
        device = _card(device, torch.cuda.device_count(), rank if backend == "nccl" else 0)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="file://" + store, world_size=n_ranks,
                            rank=rank, timeout=timedelta(seconds=timeout_s))
    try:
        out = fn(make_mesh(device, backend), *args)
        if rank == 0:
            with open(result, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, n_ranks: int, device="cuda", backend: str = None,
              args: tuple = (), timeout_s: float = 600, workdir: str = None):
    """fn(mesh, *args) in n_ranks spawned processes, the ranks of one
    process group on a file:// store in a new temp dir under `workdir`
    (CPU ranks take one thread each; on the card NCCL ranks take card
    rank % cards and gloo ranks share card 0, unless `device` names one);
    returns rank 0's result.  fn must be importable by name.  Raises if a
    rank fails, and kills every rank past timeout_s."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks: no CUDA device")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    with tempfile.TemporaryDirectory(prefix="plonkit_ranks_", dir=workdir) as tmp:
        result = os.path.join(tmp, "result.pickle")
        deadline = time.monotonic() + timeout_s
        ctx = mp.start_processes(
            _rank_entry, args=(n_ranks, str(device), backend, os.path.join(tmp, "store"),
                               result, timeout_s, fn, args),
            nprocs=n_ranks, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{n_ranks} ranks ran past {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        with open(result, "rb") as f:
            return pickle.load(f)
