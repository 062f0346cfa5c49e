"""The traced run: a torch.profiler over the whole window (host and device
activities), the program's stage spans marked in it, probes around the
program's kernel wrappers for the per-layer readers, and the reduction of
the trace to device time by name, the device's busy time and its idle gaps
by what the host was doing."""

import bisect
import importlib
import json
import os
import tempfile
from contextlib import contextmanager


class Store:
    """What one metric's probes record: `items[phase]` lists their records
    in order, phase "warmup" (the set-up's requests) or "window"."""

    def __init__(self):
        self.phase = "warmup"
        self.items = {"warmup": [], "window": []}

    def add(self, record) -> None:
        self.items[self.phase].append(record)


def install_probes(stores: dict, probes: dict) -> list:
    """Wrap each probed function of the program: `probes` maps a metric to
    [(module, attribute, record(store, args, out))], where the attribute is
    a function of the module or a dotted path to a method ("Class.method":
    args then starts with the instance); a call runs the original, then
    each record.  Returns the undo list."""
    by_target = {}
    for metric, plist in probes.items():
        for module, attr, record in plist:
            by_target.setdefault((module, attr), []).append((stores[metric], record))
    undo = []
    for (module, attr), hooks in by_target.items():
        owner = importlib.import_module(module)
        *path, name = attr.split(".")
        for part in path:
            owner = getattr(owner, part)
        original = getattr(owner, name)

        def wrapped(*args, _original=original, _hooks=hooks, **kwargs):
            out = _original(*args, **kwargs)
            for store, record in _hooks:
                record(store, args, out)
            return out
        setattr(owner, name, wrapped)
        undo.append((owner, name, original))
    return undo


def remove_probes(undo: list) -> None:
    for owner, name, original in undo:
        setattr(owner, name, original)


@contextmanager
def stage_spans():
    """Mark each of the program's `profiling.stage`s as a span of its name in
    the profiler's trace, through the program's own inner-span path: with
    PLONKIT_TPU_TRACE set, a stage entered while a traced one is active
    (`profiling._tracing["active"]`) is a bare record_function of its name
    and writes no file.  Where the program lacks that path nothing is set,
    and the trace has the requests' spans alone."""
    from plonkit_tpu_torch import profiling
    state = getattr(profiling, "_tracing", None)
    if not (isinstance(state, dict) and state.get("active") is False):
        yield
        return
    saved_env = os.environ.get("PLONKIT_TPU_TRACE")
    os.environ["PLONKIT_TPU_TRACE"] = os.path.join(tempfile.gettempdir(), "portbench_no_trace")
    state["active"] = True
    try:
        yield
    finally:
        state["active"] = False
        if saved_env is None:
            del os.environ["PLONKIT_TPU_TRACE"]
        else:
            os.environ["PLONKIT_TPU_TRACE"] = saved_env


def profiler():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


DEVICE_CATEGORIES = {"kernel", "gpu_memcpy", "gpu_memset"}


def events(prof) -> list:
    """The profiled window's complete events, read from its Chrome trace:
    the exporter writes it in one native call, far faster than building
    python event objects.  The file goes to the temporary directory and is
    removed once read."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return [e for e in trace.get("traceEvents", trace if isinstance(trace, list) else [])
            if e.get("ph") == "X"]


def reduce(prof, span_names: set, request_span: str) -> dict:
    """Device events and host spans of a profiled window: {"device": [(name,
    start_us, end_us)], "by_name": {name: [count, seconds]}, "busy_s",
    "gaps": {span: [count, seconds]}}: each idle gap between device
    activity named by the innermost host span over its middle."""
    device, spans = [], []
    marks = span_names | {request_span}
    for e in events(prof):
        cat, s = e.get("cat", ""), float(e["ts"])
        end = s + float(e.get("dur", 0))
        if cat in DEVICE_CATEGORIES:
            device.append((e["name"], s, end))
        elif cat == "user_annotation" and e["name"] in marks:
            # a span appears on the host and, as gpu_user_annotation, on the device
            spans.append((s, end, e["name"]))
    by_name = {}
    for name, s, e in device:
        rec = by_name.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (e - s) / 1e6
    merged = []
    for s, e in sorted((s, e) for _, s, e in device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    spans.sort()
    req = [(s, e) for s, e, n in spans if n == request_span]
    lo = req[0][0] if req else (merged[0][0] if merged else 0)
    hi = req[-1][1] if req else (merged[-1][1] if merged else 0)
    starts, labels = _innermost(spans)
    gaps = {}
    edges = [lo] + [x for m in merged for x in m] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        at = bisect.bisect_right(starts, (a + b) / 2) - 1
        name = labels[at] if at >= 0 else "outside any span"
        rec = gaps.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (b - a) / 1e6
    return {"device": device, "by_name": by_name,
            "busy_s": sum(e - s for s, e in merged) / 1e6, "gaps": gaps,
            "span_s": (hi - lo) / 1e6}


def _innermost(spans: list) -> tuple:
    """The host's timeline cut where a span starts or ends: (the cuts, the
    name of the innermost span, the one begun last, from each cut on)."""
    cuts = sorted([(s, 1, i) for i, (s, _, _) in enumerate(spans)]
                  + [(e, 0, i) for i, (_, e, _) in enumerate(spans)])
    active, starts, labels = {}, [], []
    for t, is_start, i in cuts:
        if is_start:
            active[i] = spans[i][2]
        else:
            active.pop(i, None)
        label = next(reversed(active.values())) if active else "outside any span"
        if starts and starts[-1] == t:
            labels[-1] = label
        else:
            starts.append(t)
            labels.append(label)
    return starts, labels


def device_seconds(by_name: dict, patterns) -> float:
    """Device seconds of the events whose name holds any of `patterns`."""
    return sum(sec for name, (_, sec) in by_name.items()
               if any(p in name for p in patterns))


def breakdown(red: dict) -> dict:
    ops = sorted(red["by_name"].items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(red["gaps"].items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[name[:120], sec] for name, (_, sec) in ops],
            "idle_gaps": [[f"{name} ({count} gaps)", sec] for name, (count, sec) in gaps]}
