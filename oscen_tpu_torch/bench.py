"""Benchmark driver of oscen_tpu_torch: a model's real-time factor at
48 kHz on one CUDA card.

    python3 -m oscen_tpu_torch.bench [--model=NAME] [--block=4096,1024]
        [--mode=block|sample] [--events] [--device=cpu]

The counterpart of the JAX package's ``bench.py``: the same eight models
at the same widths (``--model=``: electric_piano, the default, poly_synth,
fm_synth and pivot at 256 voices; readme_synth, simple_echo, saturator
(4x) and twin_peaks, one instance each), the same chord (note
``36 + i % 64`` at velocity 100 on ``midi_in`` for every voice, when the
graph has that input), the same protocol, metric names and keys, plus
``"device"`` (the card's name) and the span lengths ``n_small`` /
``n_large``.

Steady lines.  Both latency classes are measured: B=4096 (bulk, 85 ms)
and B=1024 (streaming, 21 ms), one JSON line each,
``{model}_{V}v_rtf_48k_b4096`` and ``{model}_{V}v_rtf_48k``, the streaming
line last.  Each block size runs completely, the headline class (the last
of ``--block``) first: compile, the chord's block, two steady blocks (the
steady key's warm-up and its capture), a warm block's time
(:func:`block_seconds`, from spans of 1 and 9 blocks), the spans it sizes
(:func:`spans`), a warm-up of both spans, one window, its line.  Refinement windows follow while the budget lasts (at most
``MAX_WINDOWS`` per block size), re-emitted in ``--block`` order so that
the headline line stays last: take the last line per metric.

A window is the median of 5 differences ``span(n_large) -
span(n_small)``, each span a host clock around ``steady_checksum(n)``.
The port's ``steady_checksum`` (``jit=True``, the default) is one staging,
then a replay of one captured CUDA graph per block that also adds the
block's energy into a scalar on the card, and one ``.item()`` at the end,
a device sync; so a span measures the host's replay calls plus device time
(per block, the larger of the two where they overlap), not device time
alone.  The difference cancels what every span pays once:
the staging prepass (``_steady_staging``) and the final read.  ``value``
is the best window's real-time factor, ``median_window`` the median
window's, ``us_per_block`` the best window's wall per block.  The twin
peaks and the echo are effects, yet get no audio here, as in ``bench.py``:
``steady_checksum`` stages no stream input.

Events lines (``--events``): every block queues a note-off and a note-on
at offset 17 and calls ``process_block()``; outputs are not fetched; each
loop of 200 blocks ends in ``torch.cuda.synchronize()``, after 8 warm-up
blocks, and a line ``{model}_{V}v_events_rtf_48k_b{B}`` follows each loop
(the best loop so far), after a ``[bench] events`` marker with the graph's
``block_counts`` and ``eager_why`` so far: with ``jit=True`` the loop's
event blocks are replays of one captured block, eager only where a key
warms up.  The host prepass, the staging copy and the replay (or the
eager dispatch) are inside this measurement.  Each block size gets at most
``MAX_WINDOWS`` loops, so that every size of ``--block`` gets its line.

``vs_baseline`` divides by the port's first target, 100x real time
(PERF.md, section 2), on both kinds of line.

The command supervises the measurement, a child process (``--child``),
under a wall budget, ``OSCEN_BENCH_BUDGET_S`` (default 420 s): the child
is killed at the deadline, or at once on SIGTERM, and whatever it printed
stands (exit code 0 if it printed a line).  A child that
prints no ``[bench]`` marker within ``OSCEN_BENCH_INIT_TIMEOUT_S`` (75 s)
is killed and started again while the budget allows.  The child prints a
marker before it builds the package's CUDA sources (``build.SOURCES``, all
at once, one ``nvcc`` each), so a slow build is never taken for a hang.  Any other end
of the child is final and not retried: without a card it exits 2 at once,
and a failed build or launch raises.  ``OSCEN_BENCH_TEST_HANG=1`` makes
the child hang before its first marker (the watchdog's self-test).

``--device cpu`` is the CPU rehearsal, for the tests: its lines carry
``"device": "cpu"`` and metric names that start with ``cpu_``, so a CPU
number never stands under a card metric's name.  Without it the bench
needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from .models.electric_piano import build_electric_piano
from .models.fm_synth import build_fm_synth
from .models.pivot import build_pivot
from .models.poly_synth import build_poly_synth
from .models.simple import (build_saturator, build_simple_echo,
                            build_simple_synth)
from .models.twin_peaks import build_twin_peaks
from .nodes.midi import raw_midi_event

SR = 48_000.0
VOICES = 256
BLOCKS = (4096, 1024)        # the streaming class last: the headline
MAX_WINDOWS = 7
TARGET_RTF = 100.0           # the port's first target (PERF.md, section 2)
# spans: the long one lasts about SPAN_S, within [MIN_LARGE, MAX_LARGE]
# blocks (bench.py's 2048, sized for ~20 us TPU blocks); the short one is
# an eighth of it (bench.py's 256).  A warm block is timed by the spans of
# SIZING blocks.
SPAN_S = 1.0
SIZING = (1, 9)
MIN_LARGE = 8
MAX_LARGE = 2048
EVENT_LOOP = 200             # blocks per events loop
EVENT_WARMUP = 8
RETRY_BACKOFF_S = 10.0       # between child attempts
CHILD_MARGIN_S = 4.0         # the child stops measuring this far before
NO_CARD = 2                  # the child's exit code without a card

# --model= name -> (builder, has voices)
MODELS = {
    "electric_piano": (build_electric_piano, True),
    "poly_synth": (build_poly_synth, True),
    "fm_synth": (build_fm_synth, True),
    "pivot": (build_pivot, True),
    # BASELINE.md configs 1, 2 and 4 and the nih-twin-peaks plugin graph
    "readme_synth": (build_simple_synth, False),
    "simple_echo": (build_simple_echo, False),
    "saturator": (lambda: build_saturator(factor=4), False),
    "twin_peaks": (build_twin_peaks, False),
}


def build_model(name: str, voices: int = VOICES):
    """``bench.py``'s model table: the graph of ``--model=name`` and its
    voice count (1 for a one-instance graph, whatever ``voices`` says)."""
    if name not in MODELS:
        raise SystemExit(f"unknown --model={name} (electric_piano, "
                         f"poly_synth, fm_synth, pivot, readme_synth, "
                         f"simple_echo, saturator, twin_peaks)")
    build, voiced = MODELS[name]
    return (build(voices), voices) if voiced else (build(), 1)


def strike_chord(synth, voices: int) -> None:
    """Queue ``bench.py``'s chord at offset 0: note ``36 + i % 64`` at
    velocity 100 for each of ``voices`` voices, when the graph has a
    ``midi_in`` input."""
    if any(i.name == "midi_in" for i in synth.ir.inputs):
        for i in range(voices):
            synth.queue_event("midi_in", 0,
                              raw_midi_event([0x90, 36 + (i % 64), 100]))


def block_seconds(span_short: float, span_long: float) -> float:
    """A warm block's time from spans of ``SIZING[0]`` and ``SIZING[1]``
    blocks: their difference over the blocks between, which cancels what
    every span pays once (the staging prepass and the final read)."""
    return max(span_long - span_short, 0.0) / (SIZING[1] - SIZING[0])


def spans(block_s: float) -> Tuple[int, int]:
    """``(n_small, n_large)`` for a steady block that takes ``block_s``
    seconds: ``n_large`` lasts about ``SPAN_S``, at most ``MAX_LARGE`` and
    at least ``MIN_LARGE`` blocks; ``n_small`` is an eighth of it, at least
    one block."""
    n_large = int(min(MAX_LARGE, max(MIN_LARGE,
                                     SPAN_S / max(block_s, 1e-9))))
    return max(1, n_large // 8), n_large


def metric_name(model: str, voices: int, block: int, headline: bool,
                events: bool = False, device: str = "cuda") -> str:
    """``bench.py``'s metric names; ``cpu_`` before a CPU run's."""
    prefix = "cpu_" if device == "cpu" else ""
    if events:
        return f"{prefix}{model}_{voices}v_events_rtf_48k_b{block}"
    return (f"{prefix}{model}_{voices}v_rtf_48k"
            + ("" if headline else f"_b{block}"))


def parse_args(argv: Sequence[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python3 -m oscen_tpu_torch.bench",
        description="Real-time factor of a model on the CUDA card.")
    ap.add_argument("--model", default="electric_piano", help=", ".join(
        MODELS))
    ap.add_argument("--block", default=list(BLOCKS),
                    type=lambda s: [int(b) for b in s.split(",")],
                    help="block sizes, the headline last (4096,1024)")
    ap.add_argument("--mode", default="block", choices=("block", "sample"))
    ap.add_argument("--events", action="store_true",
                    help="a note-off and a note-on every block")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the CPU rehearsal (cpu_ metric names)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


# --------------------------------------------------------------------------
# Supervisor: the wall budget and the start-up watchdog around the child.
# --------------------------------------------------------------------------

def _kill(child: subprocess.Popen) -> None:
    """Kill the child and whatever it started (its own process group)."""
    try:
        os.killpg(child.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def supervise(argv: Sequence[str]) -> int:
    deadline = time.monotonic() + float(
        os.environ.get("OSCEN_BENCH_BUDGET_S", "420"))
    stop: List[int] = []   # SIGTERM: end now, as at the deadline
    signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
    init_timeout = float(os.environ.get("OSCEN_BENCH_INIT_TIMEOUT_S", "75"))
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[1])
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    attempt = 0
    while True:
        attempt += 1
        env["OSCEN_BENCH_CHILD_DEADLINE_S"] = str(
            max(5.0, deadline - time.monotonic() - 1.0))
        child = subprocess.Popen(
            [sys.executable, "-m", "oscen_tpu_torch.bench", "--child",
             *argv], stdout=subprocess.PIPE, text=True, bufsize=1, env=env,
            start_new_session=True)
        seen = {"json": False, "marker": False}

        def pump(proc=child, seen=seen):
            for line in proc.stdout:
                print(line.rstrip("\n"), flush=True)
                s = line.strip()
                if s.startswith("{") and s.endswith("}"):
                    try:
                        json.loads(s)
                    except ValueError:
                        continue
                    seen["json"] = True
                elif s.startswith("[bench]"):
                    seen["marker"] = True

        reader = threading.Thread(target=pump, daemon=True)
        reader.start()
        t_spawn = time.monotonic()
        hung = at_deadline = False
        try:
            while child.poll() is None:
                now = time.monotonic()
                if now >= deadline or stop:
                    at_deadline = True
                    _kill(child)
                    break
                if (not seen["marker"] and not seen["json"]
                        and now - t_spawn > init_timeout):
                    print(f"[bench] attempt {attempt}: no progress marker "
                          f"in {init_timeout:.0f} s: killing the child",
                          file=sys.stderr, flush=True)
                    hung = True
                    _kill(child)
                    break
                time.sleep(0.25)
        finally:
            if child.poll() is None:   # the supervisor was interrupted
                _kill(child)
        rc = child.wait()
        reader.join(timeout=5.0)
        if not hung:
            # the child's own end is final; at the deadline or on
            # SIGTERM what it printed stands
            if seen["json"] and (rc == 0 or at_deadline):
                return 0
            return rc if rc > 0 else 1
        if stop or time.monotonic() + RETRY_BACKOFF_S + 30.0 >= deadline:
            return 1
        print(f"[bench] attempt {attempt} produced no result: retrying in "
              f"{RETRY_BACKOFF_S:.0f} s", file=sys.stderr, flush=True)
        time.sleep(RETRY_BACKOFF_S)
        if stop:
            return 1


# --------------------------------------------------------------------------
# Measurement child.
# --------------------------------------------------------------------------

def _device_names(device: str) -> Tuple[str, str]:
    """(the card's name, nvidia-smi's "name, power.limit"), or ("cpu",
    "cpu")."""
    if device == "cpu":
        return "cpu", "cpu"
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(0), smi


def measure(args: argparse.Namespace, model=None) -> int:
    """The measurement child: ``args`` as parsed, ``model`` a
    ``build_model`` result (by default ``build_model(args.model)``; tests
    pass a narrower one)."""
    stop_by = time.monotonic() + float(os.environ.get(
        "OSCEN_BENCH_CHILD_DEADLINE_S", "1e9")) - CHILD_MARGIN_S
    if os.environ.get("OSCEN_BENCH_TEST_HANG"):   # the watchdog's self-test
        time.sleep(1e9)
    import torch
    print(f"[bench] torch {torch.__version__}, device {args.device}",
          flush=True)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("oscen_tpu_torch.bench: torch sees no CUDA card (the bench "
              "measures the card; --device cpu is the CPU rehearsal)",
              file=sys.stderr, flush=True)
        return NO_CARD
    graph, voices = model or build_model(args.model)
    device, smi = _device_names(args.device)
    print(f"[bench] device: {smi}", flush=True)
    if args.device == "cuda":
        from .ops.cuda import build
        print("[bench] building "
              + ", ".join(n + ".cu" for n in build.SOURCES), flush=True)
        t0 = time.perf_counter()
        build.load_all()   # raises on failure
        print(f"[bench] built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        sync = torch.cuda.synchronize
    else:
        def sync():
            pass
    blocks = args.block

    def build_one(B):
        print(f"[bench] compiling {args.model} B={B} mode={args.mode}",
              flush=True)
        synth = graph.compile(sample_rate=SR, block_size=B, mode=args.mode,
                              device=args.device)
        strike_chord(synth, voices)
        synth.process_block()      # the chord's block
        sync()
        print(f"[bench] first block rendered B={B}", flush=True)
        return synth

    def line(B, **fields):
        print(json.dumps({
            "metric": metric_name(args.model, voices, B, B == blocks[-1],
                                  args.events, args.device),
            "unit": "x_realtime", **fields, "block": B,
            "latency_ms": round(B / SR * 1e3, 1), "device": device}),
            flush=True)

    if args.events:
        if not MODELS[args.model][1]:
            raise SystemExit(f"--events queues notes on midi_in: "
                             f"{args.model} has no such input")
        for B in blocks:
            synth = build_one(B)
            note = [0]

            def one(synth=synth, note=note):
                key = 36 + (note[0] % 64)
                synth.queue_event("midi_in", 17,
                                  raw_midi_event([0x80, key, 0]))
                synth.queue_event("midi_in", 17,
                                  raw_midi_event([0x90, key, 90]))
                note[0] += 1
                synth.process_block()

            for _ in range(EVENT_WARMUP):
                one()
            sync()
            print(f"[bench] events warmup done B={B}", flush=True)
            best, loops = None, 0
            while loops < MAX_WINDOWS and time.monotonic() + 5.0 < stop_by:
                t0 = time.perf_counter()
                for _ in range(EVENT_LOOP):
                    one()
                sync()
                us = (time.perf_counter() - t0) / EVENT_LOOP * 1e6
                best = us if best is None else min(best, us)
                loops += 1
                rtf = (B / SR) / (best * 1e-6)
                print(f"[bench] events B={B} loop {loops}: block_counts "
                      f"{json.dumps(synth.block_counts)} eager_why "
                      f"{json.dumps(synth.eager_why)}", flush=True)
                line(B, value=round(rtf, 4),
                     vs_baseline=round(rtf / TARGET_RTF, 4),
                     us_per_block=round(best, 1), events_per_block=2,
                     windows=loops)
        return 0

    def span(synth, n):
        t0 = time.perf_counter()
        synth.steady_checksum(n)
        return time.perf_counter() - t0

    def window(synth, n_small, n_large):
        diffs = sorted(span(synth, n_large) - span(synth, n_small)
                       for _ in range(5))
        return max(diffs[2], 1e-9)

    def emit(B):
        n_small, n_large = counts[B]
        frames = (n_large - n_small) * B
        ws = sorted(windows[B])
        rtf = (frames / SR) / ws[0]                    # best (capability)
        rtf_median = (frames / SR) / ws[len(ws) // 2]  # typical
        line(B, value=round(rtf, 4), vs_baseline=round(rtf / TARGET_RTF, 4),
             median_window=round(rtf_median, 4),
             us_per_block=round(ws[0] / (n_large - n_small) * 1e6, 2),
             windows=len(ws), n_small=n_small, n_large=n_large)

    synths, counts, windows, window_s = {}, {}, {}, {}

    def next_window(B):
        t0 = time.monotonic()
        windows.setdefault(B, []).append(window(synths[B], *counts[B]))
        window_s[B] = time.monotonic() - t0

    for B in reversed(blocks):   # the headline class first
        synth = synths[B] = build_one(B)
        # the steady key's eager warm-up block and its capture, so that the
        # sizing spans time replays (a sample-mode capture records and
        # instantiates for seconds)
        synth.steady_checksum(2)
        counts[B] = spans(block_seconds(*(span(synth, n) for n in SIZING)))
        for n in counts[B]:
            synth.steady_checksum(n)
        print(f"[bench] warmup done B={B}, spans {counts[B]}", flush=True)
        next_window(B)
        emit(B)
        if time.monotonic() + 15.0 >= stop_by:
            break   # whatever was emitted stands
    live = [B for B in blocks if B in windows]
    for B in live:   # in --block order: the headline line last
        emit(B)
    while live and min(len(windows[B]) for B in live) < MAX_WINDOWS:
        need = sum(window_s[B] for B in live) + 2.0
        time.sleep(min(6.0, max(0.0, stop_by - time.monotonic() - need)))
        if time.monotonic() + need >= stop_by:
            break
        for B in live:
            next_window(B)
        for B in live:
            emit(B)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.child:
        return measure(args)
    return supervise([a for a in argv if a != "--child"])


if __name__ == "__main__":
    sys.exit(main())
