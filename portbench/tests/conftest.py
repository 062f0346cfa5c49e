"""Shared pieces of the benchmark's tests: the tiny cells of
data/bench_cpu.json (one Poseidon hash at a 2^12 domain, keys at 2^3), run
through the harness's own run_cell, and the card's fixture."""

import json
import os

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# the plain versions run torch's CPU ops; with every worker of a parallel
# run taking every core, their thread pools crowd each other out
torch.set_num_threads(min(2, torch.get_num_threads()))
SEED = 2 ** 31 + 2026          # above 32 signed bits, as the driver's seeds are


def tiny_bench() -> dict:
    with open(os.path.join(HERE, "data", "bench_cpu.json")) as f:
        return json.load(f)


def run_tiny(cell: str, device: str = "cpu", seconds: float = 0.1, **kw) -> dict:
    from portbench import run
    return run.run_cell(tiny_bench(), cell, kw.pop("seed", SEED), seconds, False,
                        device=device, traffic_dir=os.path.join(HERE, "data", "traffic"), **kw)


@pytest.fixture
def card():
    """The card's device name; skips the test without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
