"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are found by name from
BENCHMARK.json at the root of the checkout: the configuration's file is
named there, the mix is portbench/traffic/<traffic>.json, its kind is
portbench/kinds/<kind>.py, the configuration's circuit (if it has one)
portbench/circuits/<circuit>.py, and every metric is read by
portbench/metrics/<metric>.py.  The set-up makes every input
from the seed, warms the cell's own shapes, then the window runs requests
in turn for --seconds; the plain reference judges the answers once the
window has closed and the program's state is freed.  --trace 1 runs the
window under torch.profiler and reports the per-layer metrics instead of
the end-to-end ones.  Measures plonkit_tpu_torch only: the process exits
with 3 and prints no result if jax, jaxlib, flax or plonkit_tpu is loaded.
"""

import time

T_START = time.perf_counter()

import argparse                                                    # noqa: E402
import gc                                                          # noqa: E402
import json                                                        # noqa: E402
import os                                                          # noqa: E402
import resource                                                    # noqa: E402
import statistics                                                  # noqa: E402
import sys                                                         # noqa: E402
from contextlib import nullcontext                                 # noqa: E402
from types import SimpleNamespace                                  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import trace, workload                              # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "plonkit_tpu"}
REQUEST_SPAN = "portbench request"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_parts(bench: dict, name: str, root: str = ROOT, traffic_dir: str = None) -> tuple:
    """(cell, configuration, traffic mix) of the cell `name`; the mixes are
    read from traffic_dir, portbench/traffic by default."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(traffic_dir or os.path.join(HERE, "traffic"),
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return cell, config, traffic


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") the cell
    reports: those that list it, or list no cells and move an end-to-end
    metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[kind]:
        listed = m.get("workloads")
        if listed is not None and cell in listed:
            out.append(m)
        elif listed is None and (kind == "end_to_end" or m["moves"] in e2e):
            out.append(m)
    return out


def load_reader(name: str):
    return workload.load("metrics", name)


class _Host:
    """What the host did in the window, printed beside the result to tell
    the host's drift from the program's: the interpreter's collections
    (gc.callbacks: count and seconds), the process's CPU seconds and
    involuntary context switches (getrusage), and the seconds that the
    machine's CPUs were stolen by its hypervisor (/proc/stat, read only)."""

    def __init__(self):
        self.count, self.seconds, self._t = 0, 0.0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.count += 1
            self.seconds += time.perf_counter() - self._t
            self._t = None

    def __enter__(self):
        self._usage, self._steal = resource.getrusage(resource.RUSAGE_SELF), _steal_s()
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)
        u, s = resource.getrusage(resource.RUSAGE_SELF), _steal_s()
        self.cpu_s = (u.ru_utime + u.ru_stime) - (self._usage.ru_utime + self._usage.ru_stime)
        self.switches = u.ru_nivcsw - self._usage.ru_nivcsw
        self.steal_s = None if s is None or self._steal is None else s - self._steal


def _steal_s():
    """The machine's stolen CPU seconds so far, summed over its CPUs, or None."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


def _read(path: str):
    """A file's text, stripped, or None where it cannot be read."""
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return None


def card_bus_id(index: int = 0):
    """The card's PCI address as /sys/bus/pci/devices names it
    ("0000:1b:00.0"), from torch's device properties, or None."""
    import torch
    p = torch.cuda.get_device_properties(index)
    ids = [getattr(p, f"pci_{k}_id", None) for k in ("domain", "bus", "device")]
    return None if None in ids else "{:04x}:{:02x}:{:02x}.0".format(*ids)


def placement(bus_id) -> dict:
    """Where the process sits, read only: the CPUs it may run on
    (sched_getaffinity) and the MHz of the first of them (cpufreq, else
    /proc/cpuinfo), the card's PCI address, its NUMA node and the CPUs
    local to it (/sys/bus/pci/devices/<address>/numa_node, local_cpulist;
    -1 is the kernel's "no node").  None where the machine has no answer."""
    allowed = sorted(os.sched_getaffinity(0))
    mhz = _read(f"/sys/devices/system/cpu/cpu{allowed[0]}/cpufreq/scaling_cur_freq")
    if mhz is not None:
        mhz = int(mhz) / 1000
    else:
        processor = None
        for line in (_read("/proc/cpuinfo") or "").splitlines():
            key, _, value = (part.strip() for part in line.partition(":"))
            if key == "processor":
                processor = value
            elif key == "cpu MHz" and processor == str(allowed[0]):
                mhz = float(value)
    card = f"/sys/bus/pci/devices/{bus_id}/" if bus_id else None
    node = _read(card + "numa_node") if card else None
    return {"affinity": allowed, "cpu_mhz": mhz, "card": bus_id,
            "card_numa_node": None if node is None else int(node),
            "card_local_cpus": _read(card + "local_cpulist") if card else None}


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", t_start: float = None, control: bool = False,
             root: str = ROOT, traffic_dir: str = None) -> dict:
    """One run of a cell; returns the result line's object.  `control`
    switches on the program's own path that breaks one guarantee of the
    configuration (the kind says which); only the control's test and its
    runs on the card use it."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell, config, traffic = cell_parts(bench, name, root, traffic_dir)
    work = workload.load("kinds", traffic["kind"]).Work(config, traffic, seed, device,
                                                        control=control)
    metrics = cell_metrics(bench, name, "per_layer" if trace_on else "end_to_end")
    readers = {m["name"]: load_reader(m["name"]) for m in metrics}
    stores = {n: trace.Store() for n in readers}
    undo = trace.install_probes(stores, {n: getattr(r, "PROBES", []) for n, r in readers.items()}) \
        if trace_on else []
    cuda = device != "cpu"
    if cuda:
        import torch
    from plonkit_tpu_torch import profiling
    stages = []

    def around(i):
        profiling.reset()
        done = lambda: stages.append(dict(profiling.last_timings))      # noqa: E731
        return _Span(REQUEST_SPAN if trace_on else None, done)
    try:
        work.setup()
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        for s in stores.values():
            s.phase = "window"
        peak_before = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        red = None
        with _Host() as host:
            if trace_on:
                with trace.stage_spans(), trace.profiler() as prof:
                    kept, completed, times, errors, window_s = \
                        workload.window(work, seconds, around)
            else:
                kept, completed, times, errors, window_s = workload.window(work, seconds, around)
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        trace.remove_probes(undo)
    t_read = time.perf_counter()
    if trace_on:
        red = trace.reduce(prof, {k for s in stages for k in s}, REQUEST_SPAN)
        del prof
    read_s = time.perf_counter() - t_read
    ctx = SimpleNamespace(completed=completed, attempted=len(times), window_s=window_s,
                          setup_s=setup_s, request_s=times, stages=stages,
                          by_name=red["by_name"] if red else {},
                          busy_s=red["busy_s"] if red else None,
                          span_s=red["span_s"] if red else None,
                          window_peak_bytes=window_peak, device=device)
    values = {}
    for m in metrics:
        ctx.store = stores[m["name"]]
        v = readers[m["name"]].read(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    memory_peak = max(peak_before, window_peak)
    work.release()
    t_judge = time.perf_counter()
    verdict, refused = work.judge(kept)
    judge_s = time.perf_counter() - t_judge
    correct = completed > 0 and bool(kept) and not errors and \
        all(v <= lim for v, lim in verdict.values())
    result = {"correct": correct, "attempted": len(times),
              "failed": len(errors) + refused, "metrics": values,
              "device": _device(cuda, memory_peak, red, window_s)}
    if red is not None:
        result["breakdown"] = trace.breakdown(red)
    result["errors"] = errors[:5]
    result["seconds"] = {"setup": setup_s, "window": window_s, "trace_read": read_s,
                         "judge": judge_s}
    result["host"] = {"gc_collections": host.count, "gc_s": host.seconds,
                      "cpu_s": host.cpu_s, "involuntary_switches": host.switches,
                      "steal_s": host.steal_s, "cpus": os.cpu_count(),
                      "judged": len(kept), "request_s": _quartiles(times),
                      "witness_synthesis_s": _quartiles(
                          [s["witness synthesis"] for s in stages if "witness synthesis" in s]),
                      **placement(card_bus_id() if cuda else None)}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in verdict.items()}
    return result


def _quartiles(values: list) -> list:
    """[first quartile, median, third quartile], or [] for fewer than two."""
    return statistics.quantiles(values, n=4) if len(values) > 1 else []


class _Span:
    """A request's span in the profiler's trace (none for name None), and a
    callback at its end."""

    def __init__(self, name, at_exit):
        import torch
        self.rf = torch.profiler.record_function(name) if name else nullcontext()
        self.at_exit = at_exit

    def __enter__(self):
        self.rf.__enter__()

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        if exc[0] is None:
            self.at_exit()


def _device(cuda: bool, peak: int, red, window_s: float) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
           "memory_peak_bytes": int(peak)}
    if red is not None:
        out["busy_s"] = red["busy_s"]
        out["window_s"] = red["span_s"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"modules of the JAX package or JAX were loaded: {found}", file=sys.stderr)
        return 3
    for e in result.pop("errors"):
        print(e, file=sys.stderr)
    print("seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in result.pop("seconds").items())
          + f", all {time.perf_counter() - T_START:.3f}", file=sys.stderr)
    print("host: " + json.dumps(result.pop("host")), file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
