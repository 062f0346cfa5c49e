"""The result's host line: where the process sat (the CPUs allowed and
the first one's MHz, the card's PCI address, NUMA node and local CPUs)
beside the host's own readings, with None where the machine has no
answer."""

import os

from conftest import run_tiny
from portbench import run

PLACEMENT = {"affinity", "cpu_mhz", "card", "card_numa_node", "card_local_cpus"}


def test_host_line_holds_the_placement():
    host = run_tiny("tiny_lagrange.keygen")["host"]
    assert PLACEMENT <= set(host) and {"cpu_s", "request_s"} <= set(host)
    assert host["affinity"] == sorted(os.sched_getaffinity(0))
    # no card on the CPU: nothing to place it by
    assert host["card"] is host["card_numa_node"] is host["card_local_cpus"] is None


def test_placement_is_none_where_sys_has_no_answer():
    got = run.placement("ffff:ff:1f.7")
    assert set(got) == PLACEMENT and got["card"] == "ffff:ff:1f.7"
    assert got["card_numa_node"] is None and got["card_local_cpus"] is None
    assert run.placement(None)["card_numa_node"] is None
