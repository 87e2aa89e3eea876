"""Profiling utilities.

Counterpart of ``oscen_tpu/utils/profile.py``: a real-time-factor meter
over the steady-state render, and a ``torch.profiler`` trace context (the
JAX package's is a ``jax.profiler`` trace).  Both run on the graph's own
device: the CUDA card unless it was compiled with ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


def measure_rtf(compiled, n_blocks: int = 2048, trials: int = 5) -> dict:
    """Real-time factor of the steady-state render.

    Times a long and a short span of ``steady_checksum`` (all work forced,
    one 4-byte read at the end) and subtracts, cancelling the fixed cost of
    a span; the median of ``trials`` differences is reported."""
    n_small = max(n_blocks // 8, 1)
    for n in (n_small, n_blocks):  # warm both span lengths
        compiled.steady_checksum(n)

    def span(n):
        t0 = time.perf_counter()
        compiled.steady_checksum(n)
        return time.perf_counter() - t0

    diffs = sorted(span(n_blocks) - span(n_small)
                   for _ in range(max(trials, 1)))
    dt = max(diffs[len(diffs) // 2], 1e-9)
    frames = (n_blocks - n_small) * compiled.block_size
    per_block = dt / (n_blocks - n_small)
    return {"rtf": (frames / compiled.sample_rate) / dt,
            "seconds_per_block": per_block,
            "us_per_block": per_block * 1e6,
            "frames": frames}


@contextlib.contextmanager
def trace(log_dir=None):
    """A ``torch.profiler`` session (host and, with a card, device
    activities) whose trace is written to ``log_dir`` for TensorBoard
    (default: ``oscen_trace`` under the temporary directory).  Yields the
    profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "oscen_trace")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
