"""One run of one cell of ``BENCHMARK.json`` on the CUDA card:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The program under test is ``oscen_tpu_torch``, through its public API (a
model builder, ``Graph.compile``, ``CompiledGraph.queue_event``,
``process_block``, ``state``, ``block_counts``).  A run:

1. builds the cell's graph and compiles it at the traffic's block size on
   the card (``jit`` at its default, so blocks replay captured graphs);
2. set-up: renders the traffic's first blocks and its warm-up stretch
   (:class:`traffic.Traffic`), untimed, so that the cell's capture keys
   exist; ``setup_s`` runs from the process's start to here;
3. the window: the callback loop (:mod:`loop`) for ``--seconds``, timed on
   the host clock, each block from its callback's start to its output in
   host memory;
4. with ``--trace 1``, :data:`TRACE_S` seconds more of callbacks under
   ``torch.profiler`` (after :data:`TRACE_LEAD` untimed ones there),
   reduced by :mod:`trace` for the per-layer readers;
5. the check (:mod:`check`) against the plain reference, after the peak
   memory is read and the program is freed;
6. the result: one JSON line last on standard output; the numbers compared
   beside their limits last on standard error.

Without a card (or with fewer than the cell asks for) it exits 2 and
prints no result; so it does if JAX or the JAX package is loaded once the
window has closed.  ``--rehearse`` runs on the CPU for the tests: its
metric names start with ``cpu_`` and its device is the CPU, so no CPU
number stands under a card metric's name.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time
from contextlib import nullcontext
from pathlib import Path

import numpy as np

T_IMPORT = time.time()
# the traced stretch: short, since the profiler drops records late in a
# long process; its first callbacks, which pay the profiler's start, are
# left out of it
TRACE_S = 0.3
TRACE_LEAD = 4


def profiled(cuda: bool):
    """The profiler's activities: the device's alone, so that the host pays
    less for the trace (the host spans are the harness's own)."""
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]


FORBIDDEN = ("jax", "jaxlib", "flax", "oscen_tpu")
NO_RESULT = 2


def process_start() -> float:
    """This process's start on the wall clock (Linux), else the time this
    module was imported."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        stat = Path("/proc/self/stat").read_text()
        start = int(stat.rsplit(")", 1)[1].split()[19]) / ticks
        boot = next(float(line.split()[1]) for line in
                    Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + start
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return p.stdout.strip().replace("\n", "; ") or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def build(config: dict, block: int, device: str):
    mod, fn = config["builder"].split(":")
    g = getattr(importlib.import_module(mod), fn)(**config["builder_args"])
    c = g.compile(float(config["sample_rate"]), block_size=block,
                  device=device)
    # the configuration's patch is the graph's own defaults, not set here
    # (a set value would change which blocks the program runs)
    for gi in c.ir.inputs:
        want = config["patch"].get(gi.name)
        if isinstance(want, float) and float(gi.default) != want:
            raise SystemExit(f"{config['builder']}'s {gi.name} defaults to "
                             f"{gi.default}, the configuration holds {want}")
    return c


class Run:
    """What the per-layer readers read: the cell, the window's counts and
    host times, and the trace (``None`` without ``--trace 1``)."""

    def __init__(self, cell, m: dict):
        self.cell, self.config, self.mix = cell, cell.config, cell.mix
        self.voices = int(cell.config["voices"])
        self.block_size = int(cell.mix["block_size"])
        self.blocks, self.submit_s = m["blocks"], m["submit_s"]
        self.counts, self.trace = m["counts"], m["trace"]


def window(loop, plan, seconds: float) -> dict:
    """The measured window: callbacks back to back for ``seconds`` (and
    until the check's open stretch closes), then the last blocks awaited.
    Each block's latency runs from its callback's start to its output in
    host memory."""
    first = loop.block
    lat, submit = [], 0.0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= deadline and not plan.open:
            break
        plan.before(loop, now - t0)
        ts = loop.submit()
        submit += time.perf_counter() - ts
        plan.after(loop)
        lat += [b - a for _, a, b in loop.settle()]
    lat += [b - a for _, a, b in loop.settle(keep_all=True)]
    return {"blocks": loop.block - first,
            "window_s": time.perf_counter() - t0, "lat": lat,
            "submit_s": submit}


def end_to_end(m: dict, block: int, sample_rate: float) -> dict:
    """The end-to-end metrics of a window: audio rendered over the wall
    time, every block and all the time counted; the 95th percentile of all
    blocks' latencies; the set-up time."""
    return {"rtf": m["blocks"] * block / sample_rate / m["window_s"],
            "block_ms_p95": float(np.percentile(m["lat"], 95)) * 1e3,
            "setup_s": m["setup_s"]}


def measure(cell, seed: int, seconds: float, traced: bool, device: str,
            t_start: float) -> dict:
    """Set-up, the window and, when ``traced``, the profiled stretch of one
    run; the program's outputs and states that the check reads, on the
    host; the program freed."""
    import torch
    from oscen_tpu_torch import raw_midi_event
    from .check import Plan, START, to_host
    from .loop import Loop
    from .traffic import Traffic
    config, mix = cell.config, cell.mix
    B, sr = int(mix["block_size"]), float(config["sample_rate"])
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    marks = [("start", t_start), ("imports", time.time())]
    c = build(config, B, device)
    traffic = Traffic(mix, seed, sr, int(config["voices"]))
    loop = Loop(c, [config["output"]], config["event_input"], traffic,
                int(mix["pipeline_depth"]), raw_midi_event)
    marks.append(("build", time.time()))
    # set-up: the first blocks (kept for the check), then the warm-up
    loop.keep.update(range(START))
    loop.run_blocks(START)
    start_state = c.state
    marks.append(("first blocks", time.time()))
    loop.run_blocks(traffic.warmup_blocks - START)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("warm-up", time.time()))
    print("benchmark: set-up " + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b) in zip(marks, marks[1:]))
        + f"; block counts {c.block_counts}", file=sys.stderr)

    # the window
    plan = Plan(seed, seconds)
    counts0 = c.block_counts
    setup_s = time.time() - t_start
    m = window(loop, plan, seconds)
    counts1 = c.block_counts
    m.update(setup_s=setup_s, traffic=traffic, trace=None,
             counts={k: counts1[k] - counts0.get(k, 0) for k in counts1})

    if traced:
        from torch.profiler import profile
        from . import trace as tr
        spans = tr.HostSpans()
        with profile(activities=profiled(cuda)) as prof:
            loop.run_blocks(TRACE_LEAD)
            if cuda:
                torch.cuda.synchronize()
            loop.span = spans
            first = loop.block
            t_a = time.time_ns()
            while time.time_ns() - t_a < TRACE_S * 1e9:
                loop.submit()
                loop.settle()
            loop.settle(keep_all=True)
            if cuda:
                torch.cuda.synchronize()
            t_b = time.time_ns()
        loop.span = nullcontext
        m["trace"] = tr.reduce(prof, loop.block - first, t_a, t_b, spans)

    m["peak"] = int(torch.cuda.max_memory_allocated()) if cuda else 0
    # the program's state, kept where it was read, to the host; the
    # program freed before the check
    m["start"] = to_host(start_state)
    for seg in plan.segments:
        seg["before"], seg["after"] = to_host(seg["before"]), \
            to_host(seg["after"])
    m["segments"], m["kept"] = plan.segments, loop.kept
    del loop, c, start_state
    if cuda:
        torch.cuda.empty_cache()
    return m


def judge(cell, m: dict, control=None) -> list:
    """The check's stretches (``check.run_reference``) of a measured run;
    ``control``: the lower precision that stands in for the program."""
    from .check import run_reference
    return run_reference(cell.config, m["traffic"], m["start"],
                         m["segments"], m["kept"], cell.config["output"],
                         control=control)


def run(args) -> int:
    import torch
    torch.set_num_threads(1)
    from .cell import load
    from .check import failures, numbers, out_gap, verdict
    root = Path(args.root) if args.root else Path(__file__).resolve() \
        .parents[1]
    cell = load(root, args.workload)
    if args.rehearse:
        device = "cpu"
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); "
                  f"this machine has {have}", file=sys.stderr)
            return NO_RESULT
        device = "cuda"
    m = measure(cell, args.seed, args.seconds, bool(args.trace), device,
                process_start())
    cuda = device == "cuda"
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    if cuda:
        print(f"benchmark: card {power_limit()}", file=sys.stderr)
    print(f"benchmark: {cell.name} seed {args.seed}: {m['blocks']} blocks in "
          f"{m['window_s']:.3f} s, block counts {m['counts']}, set-up "
          f"{m['setup_s']:.3f} s", file=sys.stderr)
    t_check = time.perf_counter()
    results = judge(cell, m)
    nums = numbers(results)
    limits = {k: float(v) for k, v in cell.config["limits"].items()}
    print(f"benchmark: the check of {len(results)} stretches took "
          f"{time.perf_counter() - t_check:.1f} s; out_gap by stretch "
          f"{[float(f'{out_gap(r):.4g}') for r in results]}",
          file=sys.stderr)

    pre = "" if cuda else "cpu_"
    B, sr = int(cell.mix["block_size"]), float(cell.config["sample_rate"])
    metrics = {}
    if args.trace:
        r = Run(cell, m)
        for spec in cell.per_layer:
            v = cell.readers[spec["name"]].read(r)
            if v is not None:
                metrics[pre + spec["name"]] = {"value": float(v),
                                               "unit": spec["unit"]}
    else:
        e2e = end_to_end(m, B, sr)
        for spec in cell.end_to_end:
            metrics[pre + spec["name"]] = {"value": e2e[spec["name"]],
                                           "unit": spec["unit"]}
    result = {"correct": verdict(nums, limits), "attempted": m["blocks"],
              "failed": failures(results, limits), "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                         "count": cell.chips if cuda else 0,
                         "memory_peak_bytes": m["peak"]}}
    t = m["trace"]
    if t is not None and cuda:
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": t.device_ops(),
                               "idle_gaps": t.idle_gaps()}
    result["checked"] = {k: {"value": nums[k], "limit": limits[k]}
                         for k in limits}
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return NO_RESULT
    for k in limits:
        print(f"checked {k} {nums[k]!r} limit {limits[k]!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    return run(parse_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    sys.exit(main())
