"""Host-to-device copies and kernel time by prover stage, from the Chrome
traces that PLONKIT_TPU_TRACE=<dir> makes `profiling.stage` write.

    PLONKIT_TPU_TRACE=DIR python -m plonkit_tpu_torch recursive-prove ...   # any traced run
    python -m plonkit_tpu_torch.trace_summary DIR                          # summarise DIR/*.json

Each copy or kernel on the card is charged to the innermost stage whose
span (a `record_function` of the stage's name) holds the host call that
launched it: the trace's `cuda_runtime` event of the same correlation id.
Prints one JSON object: for every stage, the host-to-device copies by
source memory (pageable or pinned) with their count, bytes, device ms and
the largest sizes, and the kernels' count and device ms.
"""

import bisect
import glob
import json
import os
import re
import sys

TOP_SIZES = 5


def _copy_kind(name: str):
    """'Memcpy HtoD (Pageable -> Device)' -> 'HtoD pageable'; None for
    other events."""
    m = re.match(r"Memcpy (\w+) \((\w+) -> (\w+)\)", name)
    if not m:
        return None
    if m.group(1) != "HtoD":
        return m.group(1)
    return "HtoD " + m.group(2).lower()


def summarize_trace(path: str) -> dict:
    """{stage: {"copies": {kind: {count, bytes, ms, largest}}, "kernels":
    {count, ms}}} of one Chrome trace."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"), key=lambda s: (s[0], -s[1]))
    starts = [s[0] for s in spans]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}

    def stage_at(ts):
        """The shortest span that holds ts."""
        best = None
        for s, end, name in reversed(spans[:bisect.bisect_right(starts, ts)]):
            if end >= ts and (best is None or end - s < best[0]):
                best = (end - s, name)
        return best[1] if best else "(outside a stage)"

    out = {}
    for e in events:
        cat = e.get("cat")
        if cat not in ("gpu_memcpy", "kernel"):
            continue
        args = e.get("args", {})
        ts = launch_ts.get(args.get("correlation"))
        rec = out.setdefault(stage_at(ts) if ts is not None else "(launch not traced)",
                             {"copies": {}, "kernels": {"count": 0, "ms": 0.0}})
        if cat == "kernel":
            rec["kernels"]["count"] += 1
            rec["kernels"]["ms"] += e["dur"] / 1e3
            continue
        kind = _copy_kind(e["name"])
        if kind is None:
            continue
        c = rec["copies"].setdefault(kind, {"count": 0, "bytes": 0, "ms": 0.0, "sizes": {}})
        size = int(args.get("bytes", 0))
        c["count"] += 1
        c["bytes"] += size
        c["ms"] += e["dur"] / 1e3
        c["sizes"][size] = c["sizes"].get(size, 0) + 1
    for rec in out.values():
        for c in rec["copies"].values():
            sizes = c.pop("sizes")
            c["largest"] = [{"bytes": s, "count": sizes[s]}
                            for s in sorted(sizes, reverse=True)[:TOP_SIZES]]
    return out


def summarize(trace_dir: str) -> dict:
    """summarize_trace of every trace in trace_dir, by file name."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.json")))
    if not paths:
        raise FileNotFoundError(f"no Chrome trace in {trace_dir}")
    return {os.path.basename(p)[:-len(".json")]: summarize_trace(p) for p in paths}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    print(json.dumps(summarize(argv[0])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
