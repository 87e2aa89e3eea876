"""Realtime streaming host: callback-paced block processing.

Counterpart of ``oscen_tpu/utils/host.py``.  The reference's hosts are
audio callbacks pacing ``process_block`` against a device clock
(examples/src/bin/simple_synth.rs:30-57).  With no audio device here,
:class:`StreamingHost` paces against the wall clock at the graph sample
rate — the same contract: one block every ``B/sr`` seconds, live events and
params staged between callbacks, and *deadline accounting* (a block
finishing after its deadline is an xrun).

It separates the two host-side costs the reference's callback hides:

- **staging** — the host pre-pass and dispatch (Python control code, event
  staging, the eager launches until the block's work is queued on the
  card);
- **compute** — until the output block is on the host.

The host runs the graph on the graph's own device (the CUDA card unless it
was compiled with ``device="cpu"``).  Each block's output is copied to
pinned host memory without waiting and a CUDA event is recorded after the
copy; the host waits on that event ``pipeline_depth`` blocks later (the
JAX package's ``jax.block_until_ready``): a real audio callback hands the
block over the same way, so this is the one wait by design.

``report()`` returns both costs, the miss counts and the sustained
real-time factor.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["StreamingHost"]


class StreamingHost:
    def __init__(self, compiled, realtime: bool = True,
                 pipeline_depth: int = 2):
        """``pipeline_depth`` > 0 overlaps the staging of blocks
        i+1..i+depth with the card's compute and readback of block i (the
        launches are asynchronous; the output copy starts at once and is
        awaited ``depth`` blocks later).  Depth 0 is the fully synchronous
        loop.  Latency cost: output audio is available ``depth`` block
        periods after submission."""
        self.compiled = compiled
        self.realtime = realtime
        self.pipeline_depth = int(pipeline_depth)
        self.block = compiled.block_size
        self.sr = compiled.sample_rate
        self.reset_stats()

    def reset_stats(self):
        self.blocks = 0
        self.misses = 0
        self.staging_s: List[float] = []
        self.total_s: List[float] = []
        self.worst_margin_s = float("inf")
        self.wall_s = 0.0

    # ------------------------------------------------------------------ #
    @staticmethod
    def _start_readback(y: torch.Tensor):
        """(host copy, event or None): the copy of ``y`` to the host,
        started without waiting."""
        if y.device.type != "cuda":
            return y.detach(), None
        host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        host.copy_(y, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(y.device))
        return host, ev

    def run(self, seconds: float,
            on_block: Optional[Callable[["StreamingHost", float], None]]
            = None,
            collect: bool = True) -> Optional[np.ndarray]:
        """Stream for ``seconds``: one callback per block.

        ``on_block(host, t)`` runs before each block — queue events / set
        params there (the mpsc-drain phase of the reference callback).
        Returns the concatenated audio when ``collect`` (the first
        output)."""
        c = self.compiled
        n_blocks = int(round(seconds * self.sr / self.block))
        out_name = next(o.name for o in c.ir.outputs)
        chunks = []
        period = self.block / self.sr
        depth = max(self.pipeline_depth, 0)
        pending = []  # (idx, host copy, event, t_submit) awaiting readback
        start = time.perf_counter()

        def flush_one():
            idx, host, ev, t_sub = pending.pop(0)
            if ev is not None:
                ev.synchronize()
            t_done = time.perf_counter()
            if collect:
                chunks.append(host.numpy().copy())
            # the pipelined deadline: block idx must be ready depth+1
            # periods after its slot opened
            deadline = start + (idx + 1 + depth) * period
            margin = deadline - t_done
            self.worst_margin_s = min(self.worst_margin_s, margin)
            if margin < 0:
                self.misses += 1
            self.total_s.append(t_done - t_sub)

        for i in range(n_blocks):
            t = i * period
            if on_block is not None:
                on_block(self, t)
            t0 = time.perf_counter()
            y = c.process_block()[out_name]
            host, ev = self._start_readback(y)
            t1 = time.perf_counter()  # staged + dispatched (async)
            self.staging_s.append(t1 - t0)
            pending.append((i, host, ev, t0))
            while len(pending) > depth:
                flush_one()
            self.blocks += 1
            if self.realtime:
                margin = start + (i + 1) * period - time.perf_counter()
                if margin > 0:
                    time.sleep(margin)
        while pending:
            flush_one()
        self.wall_s += time.perf_counter() - start
        if collect and chunks:
            return np.concatenate(chunks, axis=0)
        return None

    # ------------------------------------------------------------------ #
    def report(self) -> Dict[str, float]:
        period = self.block / self.sr
        staging = float(np.median(self.staging_s)) if self.staging_s else 0.0
        total = float(np.median(self.total_s)) if self.total_s else 0.0
        wall_per_block = self.wall_s / self.blocks if self.blocks else 0.0
        return {
            "blocks": self.blocks,
            "block_period_ms": period * 1e3,
            "staging_ms_median": staging * 1e3,
            "block_ms_median": total * 1e3,
            "deadline_misses": self.misses,
            "worst_margin_ms": self.worst_margin_s * 1e3,
            # per-block submit->ready latency (overlapped when pipelined)
            "sustained_rtf": period / total if total > 0 else float("inf"),
            # wall-clock throughput across the run (the pipelined figure;
            # only meaningful with realtime pacing off)
            "throughput_rtf": (period / wall_per_block
                               if wall_per_block > 0 else float("inf")),
        }

    def print_report(self):
        r = self.report()
        print(f"streamed {r['blocks']} blocks "
              f"(period {r['block_period_ms']:.2f} ms)")
        print(f"  staging (host+dispatch): {r['staging_ms_median']:.3f} ms"
              f" | full block: {r['block_ms_median']:.3f} ms"
              f" | sustained RTF: {r['sustained_rtf']:.1f}x")
        print(f"  deadline misses: {r['deadline_misses']}"
              f" | worst margin: {r['worst_margin_ms']:.2f} ms")
