"""Exact sequential phase accumulation: CUDA kernel and plain version.

Counterpart of ``oscen_tpu/ops/pallas/phase.py``.  For every voice lane,
``before[t] = p; p = p + dt[t]; p = p - floor(p)``: the reference's
per-sample ``rem_euclid(1.0)`` wrap in its exact op order, so block-mode
oscillators are bit-identical across block sizes (a prefix sum would
reassociate the adds and drift).

Selection: a CPU tensor runs :func:`plain_phase_scan`, a CUDA tensor runs
the kernel of ``csrc/phase.cu`` (built at first use) or raises.
``launches`` counts the kernel's launches; the plain version is not counted.

The kernel wraps ``q = p + dt`` by a short exact path on ``[+0, 2)``
(``q - (q >= 1)``, the comparison as 1.0 or 0.0) and re-runs any 32-step
chunk in which some ``q`` lies outside it with ``floor``
(:func:`chunked_phase_scan` models both); :func:`take_reruns` reads how
many chunks re-ran on the card, :func:`wrap_sweep` checks the short path
over all 2^32 float32 ``q`` there.
"""

from __future__ import annotations

from typing import Dict

import torch

KERNEL = "phase_scan"
launches: Dict[str, int] = {KERNEL: 0}
CHUNK = 32   # steps per ring chunk (scan_stage.cuh's kChunk)
# a q outside [+0, 2) has its sign bit or bit 30 set
OUTSIDE = 0xC0000000


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


def short_wrap(q):
    """The kernel's wrap of ``q = p + dt`` on its short path: ``q - c``
    with ``c`` 1.0 where ``q >= 1``, else 0.0 (one FSET on the card); and
    where that is not ``q - floor(q)`` bit for bit, i.e. outside ``[+0, 2)``
    (the sign bit or bit 30 of ``q``'s pattern set: negatives, ``-0``,
    ``q >= 2``, inf and NaN).  Returns (the short wrap, the mask of ``q``
    outside its domain)."""
    outside = (q.view(torch.int32) & (OUTSIDE - (1 << 32))) != 0  # int32
    return q - (q >= 1.0).to(q.dtype), outside


def chunked_phase_scan(phase0, dt, chunk: int = CHUNK):
    """The kernel's algorithm in plain PyTorch: each chunk of ``chunk``
    steps by :func:`short_wrap`, and a lane's chunk in which some ``q`` fell
    outside its domain run again from the chunk's start state with
    ``floor``.  Returns (before, carry, the re-run (lane, chunk) count);
    equal to :func:`plain_phase_scan` bit for bit."""
    B = dt.shape[0]
    before = torch.empty_like(dt)
    p = phase0
    reruns = 0
    for c0 in range(0, B, chunk):
        p_start, out = p, torch.zeros_like(p, dtype=torch.bool)
        for t in range(c0, min(B, c0 + chunk)):
            before[t] = p
            p, o = short_wrap(p + dt[t])
            out |= o
        if bool(out.any()):
            reruns += int(out.sum())
            q = p_start
            for t in range(c0, min(B, c0 + chunk)):
                before[t] = torch.where(out, q, before[t])
                q = q + dt[t]
                q = q - torch.floor(q)
            p = torch.where(out, q, p)
    return before, p, reruns


def _card_only(name, dev):
    if dev.type != "cuda":
        raise ValueError(f"{name} runs the card's kernel: give it a CUDA "
                         f"tensor (got {dev})")


def take_reruns(device="cuda") -> int:
    """The (lane, chunk)s the kernel re-ran with ``floor`` on ``device``
    since the last take (a device counter, ``csrc/phase.cu``); the count
    restarts at 0.  Waits for the card."""
    from . import build
    dev = torch.device(device)
    _card_only("take_reruns", dev)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = build.entry("phase", "oscen_phase_take_reruns", 1, 0)
    build.check_launch("phase", fn(
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
        "take_reruns")
    return int(out.item())


def wrap_sweep(device="cuda"):
    """The kernel's short wrap over all 2^32 float32 patterns ``q`` on the
    card: (patterns where it differs from ``q - floor(q)`` bit for bit,
    patterns its short path takes)."""
    from . import build
    dev = torch.device(device)
    _card_only("wrap_sweep", dev)
    return build.run_sweep("phase", "oscen_phase_wrap_sweep", dev)
