"""Run one cell of the port's benchmark once.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Set-up (weights from the seed, the cell's CUDA sources built, the
seeded frames, a warm-up over every batch of the ring) counts as
``setup_s``; the window then serves for ``--seconds`` (``--trace 1``: a
traced window of at most the workload's ``trace_seconds``), the program's
state is freed, and the reference checks a sample of the window's answers
drawn from the seed. The last line of standard output is one JSON object;
the last lines of standard error are the numbers compared, each with its
limit. The tests, and the readings of the control and of planted faults,
call :func:`run` with a cell of their own (``portbench/tests/plant.py``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse      # noqa: E402
import gc            # noqa: E402
import json          # noqa: E402
import math          # noqa: E402
import os            # noqa: E402
import sys           # noqa: E402
from typing import Dict, List, Optional   # noqa: E402

# libraries that would load JAX by themselves are kept from it
for _k in ("USE_FLAX", "USE_JAX", "USE_TF"):
    os.environ.setdefault(_k, "0")


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 2) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def percentile(values: List[float], q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def profiler(dev):
    """A profiler of the card alone: a host trace of every operator would
    slow the eager launches that the window measures."""
    import torch
    acts = ([torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda"
            else [torch.profiler.ProfilerActivity.CPU])
    return torch.profiler.profile(activities=acts)


def record(prof, dev, c, **kw):
    import torch

    from portbench.core import trace
    return trace.Record(
        device=trace.device_events(prof) if dev.type == "cuda" else [],
        config=c.config, workload=c.workload, traffic=c.traffic,
        sms=(torch.cuda.get_device_properties(0).multi_processor_count
             if dev.type == "cuda" else 0), **kw)


def free(entry, dev) -> int:
    """The peak of device memory, read before the program's state is
    freed for the reference."""
    import torch
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    entry.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return peak


def serve_window(entry, c, seed: int, seconds: float, trace: int,
                 dev) -> dict:
    """Set-up's warm-up, the serving window (or a traced one), the check."""
    import torch

    from portbench.core import loop
    from portbench.traffic import generator
    t = c.traffic
    batch, in_flight = t["batch"], t["in_flight"]
    ring = generator.frame_ring(t, seed, dev)
    n_ring = ring.shape[0] // batch
    # warm-up: every batch of the ring through the whole loop, so that
    # nothing is built, compiled or first allocated inside the window
    loop.run(entry.step, ring, batch, in_flight, math.inf, dev,
             max_batches=n_ring + in_flight)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    keep = c.workload["check"]["batches"]
    prof = None
    if trace:
        seconds = min(seconds, c.workload["trace_seconds"])
        prof = profiler(dev)
        prof.start()
    w = loop.run(entry.step, ring, batch, in_flight, seconds, dev,
                 keep=keep, seed=seed)
    if prof is not None:
        prof.stop()
    peak = free(entry, dev)
    numbers, stats = entry.check(w.samples, ring, batch)
    out = {"numbers": numbers, "stats": stats, "checked": bool(w.samples),
           "peak": peak, "attempted": w.frames,
           "e2e": {"setup_s": setup_s,
                   "frames_per_s": w.frames / w.seconds,
                   "batch_p95_ms": 1e3 * percentile(w.latencies_s, 95)}}
    if prof is not None:
        out["record"] = record(prof, dev, c, window_s=w.seconds,
                               host_spans=w.spans, batches=w.batches,
                               frames=w.frames, ref_stats=stats)
    return out


def main(argv: Optional[List[str]] = None, program: str = "port") -> int:
    """One run of a cell of ``BENCHMARK.json`` on the card; ``program``
    ``"control"`` puts the cell's control in the program's place."""
    args = parse(argv)
    import torch

    from portbench.core import spec

    c = spec.cell(args.workload)
    chips = c.bench_entry["chips"]
    if not torch.cuda.is_available():
        return fail("no card: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        return fail(f"{args.workload} needs {chips} cards, "
                    f"{torch.cuda.device_count()} visible")
    return run(c, args.seed, args.seconds, args.trace, torch.device("cuda"),
               program)


def run(c, seed: int, seconds: float, trace: int, dev,
        program: str = "port") -> int:
    """One run of cell ``c`` (a :class:`portbench.core.spec.Cell`) on
    ``dev``. The tests pass a cell cut to a small size and the CPU, where
    the port runs its plain versions and no device metric is read."""
    import torch

    from portbench.core import guard, spec, trace as traced
    chips = c.bench_entry["chips"]
    mod = spec.entry_module(c.workload["entry"])
    entry = mod.Entry(c.config, c.traffic, c.workload, seed, dev,
                      program=program)
    out = serve_window(entry, c, seed, seconds, trace, dev)
    limits: Dict[str, float] = c.workload["check"]["limits"]
    numbers, stats = out["numbers"], out["stats"]
    checks = {n: {"value": v, "limit": limits[n]} for n, v in numbers.items()}
    correct = (out["checked"] and set(numbers) == set(limits)
               and all(numbers[n] <= limits[n] for n in numbers))
    metrics: Dict[str, dict] = {}
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                       else "cpu"),
              "count": chips if dev.type == "cuda" else 0,
              "memory_peak_bytes": int(out["peak"])}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": 0}
    if not trace:
        # an end-to-end metric ``<quantity>[.<family>]`` reads its quantity:
        # each family of cells holds its own bound on it
        for m in c.end_to_end:
            q = m["name"].split(".")[0]
            if q in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][q],
                                      "unit": m["unit"]}
    elif dev.type == "cuda":
        rec = out["record"]
        for m in c.per_layer:
            v = spec.metric_reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = rec.busy_s()
        device["window_s"] = rec.window_s
        result["breakdown"] = traced.breakdown(rec)
    result["metrics"] = metrics
    result["device"] = device
    bad = guard.forbidden_modules()
    if bad:
        return fail("forbidden modules loaded in the measuring process: "
                    + ", ".join(bad), 3)
    if dev.type == "cuda":
        info = power_limit()
        if info:
            print(f"card: {info}", file=sys.stderr)
    result["checks"] = checks
    print("reference: " + json.dumps(stats), file=sys.stderr)
    for n, v in checks.items():
        print(f"check {n} {v['value']!r} limit {v['limit']!r} "
              f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().replace("\n", "; ")


if __name__ == "__main__":
    sys.exit(main())
