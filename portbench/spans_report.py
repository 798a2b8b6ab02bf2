"""Where the host sits in each batch of a cell's traced window, by the
port's own spans.

    python3 -m portbench.spans_report --workload <cell> --seed <n> \
        --seconds <s>

from the root of a checkout, on a machine with the card: one traced window
of the cell (as ``run.py --trace 1`` serves it, at most the workload's
``trace_seconds``), then one JSON line: by span name the calls and the
host ms and self ms a batch; the launch counters' change a call of each
top-level span; the window's idle share, put down to each top-level span
of the port and to the time outside them. Reads nothing where the program
has no tracer. Not a metric of the benchmark: the breakdown a change that
cuts host time starts from.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.spans_report")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch

    from portbench import run
    from portbench.core import spans, spec
    if not torch.cuda.is_available():
        return run.fail("no card: torch.cuda.is_available() is False")
    c = spec.cell(args.workload)
    dev = torch.device("cuda")
    entry = spec.entry_module(c.workload["entry"]).Entry(
        c.config, c.traffic, c.workload, args.seed, dev)
    out = run.serve_window(entry, c, args.seed, args.seconds, 1, dev)
    rec = out["record"]
    t = spans.tracer()
    if t is None or not rec.batches:
        return run.fail("the program kept no spans", 1)
    summary = t.summary()
    per_batch = {n: {"calls": s["calls"],
                     "host_ms": s["total_ms"] / rec.batches,
                     "self_ms": s["self_ms"] / rec.batches}
                 for n, s in summary["spans"].items()}
    idle = {}
    for n in sorted({r.name for r in t.spans() if r.parent is None}):
        us = spans.idle_inside_us(rec, (n,))
        idle[n] = None if us is None else 100.0 * us / 1e6 / rec.window_s
    idle_share = 100.0 * (1.0 - rec.busy_s() / rec.window_s)
    idle["outside the port"] = idle_share - sum(v or 0.0
                                                for v in idle.values())
    axis = t.device_axis(rec.device)
    anchors = t.device_offsets_us(rec.device)
    print(json.dumps({
        "workload": args.workload, "batches": rec.batches,
        "window_s": rec.window_s,
        "host_ms_per_batch": (1e3 * sum(rec.host_spans["serve.call"])
                              / rec.batches),
        "spans_per_batch": per_batch,
        "launches_per_call": summary["launches"],
        "idle_share": idle_share, "idle_share_by_span": idle,
        "anchors": len(anchors),
        "anchors_kept": len(axis.at_us) if axis else 0,
        "anchor_offsets_us_less_first": [o - anchors[0] for o in anchors],
        "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
