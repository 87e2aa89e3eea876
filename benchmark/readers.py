"""What the per-layer metrics (``metrics/<name>.py``) share: each reads one
quantity of a finished run (:class:`run.Run`) and returns ``None`` where it
finds nothing to read, so that the harness leaves the metric out."""

from __future__ import annotations

from typing import Optional

# the names of PyTorch's own device work: ATen's kernels (and the CUB
# they call), and the copies and fills (the runtime's, and the driver's
# copy kernels inside a replayed graph, such as ``memcpy32_post``).  Every
# other kernel is the program's own (hand-written CUDA, or any kernel a
# later change writes), so a kernel that takes glue over moves it out of
# this count.
PYTORCH_MARKS = ("at::", "at_cuda_detail", "c10::", "cub::")
COPY_MARKS = ("memcpy", "memset")


def is_glue(name: str) -> bool:
    return name.lower().startswith(COPY_MARKS) or any(
        m in name for m in PYTORCH_MARKS)


def submit_us(run) -> Optional[float]:
    """The host's mean time a callback, queueing its MIDI, running
    ``process_block`` and enqueueing the readback, in microseconds."""
    if not run.blocks:
        return None
    return run.submit_s / run.blocks * 1e6


def glue_us(run) -> Optional[float]:
    """Device time a block in PyTorch's kernels and copies, microseconds."""
    t = run.trace
    if t is None or not t.device or not t.blocks:
        return None
    ns = sum(d for name, _, d in t.device if is_glue(name))
    return ns * 1e-3 / t.blocks
