"""What the roofline metrics (``metrics/*_roofline.py``) share: the card's
peaks, and a kernel role's share of its least time in the trace.

Peaks: NVIDIA H100 SXM data sheet, 3.35 TB/s of HBM and 67 TFLOP/s in
float32 outside the tensor cores, at the full 700 W (the run prints the
card's power limit).  A role's work is counted from the cell's shapes in
its metric's file, whatever kernel implements it: the operations a sample
step and lane from the kernel's loop (compares and selects not counted, a
transcendental counts 1), the bytes each input read once and each output
written once.  Frozen here from the port's own accounting (``OPS_PER_STEP``
and ``bound_of`` in ``chip_smoke.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32 = 4


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the bytes over the memory rate
    or the operations over the float32 rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def base_name(kernel: str) -> str:
    """A profiler kernel name without its return type, namespaces and
    template or argument lists."""
    base = kernel.replace("(anonymous namespace)::", "")
    base = base.split("(")[0].split("<")[0]
    return base.split()[-1].split("::")[-1] if base.split() else base


def share(run, names: Sequence[str],
          work: Callable[[int, int], tuple]) -> Optional[float]:
    """The share, in %, of the least time of a role's work in the profiler
    time of the launches that implement it (kernels named ``names``) in
    the traced stretch; ``None`` where none ran there."""
    t = run.trace
    if t is None:
        return None
    launches = [d for n, _, d in t.device if base_name(n) in names]
    spent = sum(launches) * 1e-9
    if spent <= 0:
        return None
    least = least_seconds(*work(run.voices, run.block_size)) * len(launches)
    return 100.0 * least / spent
