"""Exact sequential phase accumulation: CUDA kernel and plain version.

Counterpart of ``oscen_tpu/ops/pallas/phase.py``.  For every voice lane,
``before[t] = p; p = p + dt[t]; p = p - floor(p)``: the reference's
per-sample ``rem_euclid(1.0)`` wrap in its exact op order, so block-mode
oscillators are bit-identical across block sizes (a prefix sum would
reassociate the adds and drift).

Selection: a CPU tensor runs :func:`plain_phase_scan`, a CUDA tensor runs
the kernel of ``csrc/phase.cu`` (built at first use) or raises.
``launches`` counts the kernel's launches; the plain version is not counted.
"""

from __future__ import annotations

from typing import Dict

import torch

KERNEL = "phase_scan"
launches: Dict[str, int] = {KERNEL: 0}


def reset_launches() -> None:
    launches[KERNEL] = 0


def phase_scan(phase0, dt):
    """Sequential wrapped phase accumulation.

    Args: ``phase0`` ``[V]`` carry; ``dt`` ``[B, V]`` per-sample increments.
    Returns (``before`` ``[B, V]``, the phase *before* each increment, the
    value the reference synthesizes with, and the final carry ``[V]``).
    """
    if dt.dim() != 2 or tuple(phase0.shape) != (dt.shape[1],):
        raise ValueError(f"phase_scan takes phase0 [V] and dt [B, V] (got "
                         f"{tuple(phase0.shape)} and {tuple(dt.shape)})")
    if dt.device.type == "cpu":
        return plain_phase_scan(phase0, dt)
    if dt.device.type != "cuda":
        raise ValueError(f"no phase_scan kernel for device {dt.device}")
    from . import build
    build.check_operands(dt.device, phase0=phase0, dt=dt)
    B, V = dt.shape
    before = torch.empty_like(dt)
    carry = torch.empty_like(phase0)
    fn = build.entry("phase", "oscen_phase_scan", 4, 2)
    rc = fn(phase0.data_ptr(), dt.data_ptr(), before.data_ptr(),
            carry.data_ptr(), V, B,
            torch.cuda.current_stream(dt.device).cuda_stream)
    launches[KERNEL] += 1
    build.check_launch("phase", rc, KERNEL)
    return before, carry


def plain_phase_scan(phase0, dt):
    """The kernel's per-sample loop in plain PyTorch, over ``[V]`` rows."""
    before = torch.empty_like(dt)
    p = phase0
    for t in range(dt.shape[0]):
        before[t] = p
        p = p + dt[t]
        p = p - torch.floor(p)   # rem_euclid(1.0), never trunc
    return before, p
