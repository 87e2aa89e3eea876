"""Phase accumulation over a block.

Counterpart of ``oscen_tpu/ops/scan.py``.  The JAX package's associative
affine scans (``affine_scan*``) have no caller there and are not ported
(ROADMAP.md queue 1).
"""

from __future__ import annotations

import math

import torch

from .cuda.phase import phase_scan


def exact_wrapped_phase(phase0, dt):
    """Sequential-exact wrapped phase accumulation.

    Op-order parity with the per-sample tick (``p += dt; p -= floor(p)``),
    which makes block-mode output *bit-identical across block sizes*.  The
    trailing dims of ``dt`` are flattened into the lanes of one
    ``phase_scan`` (the kernel on a CUDA tensor, its plain version on the
    CPU).

    ``dt`` is time-leading ``[B, ...]``; ``phase0`` broadcasts to ``dt``'s
    trailing dims.  Returns ``(before [B, ...], carry [...])`` where
    ``before[t]`` is the wrapped phase *prior* to adding ``dt[t]``.
    """
    trailing = tuple(dt.shape[1:])
    B = dt.shape[0]
    V = math.prod(trailing)
    p0 = torch.as_tensor(phase0, dtype=torch.float32, device=dt.device)
    p0 = torch.broadcast_to(p0, trailing).reshape(V).contiguous()
    before, carry = phase_scan(p0, dt.reshape(B, V).contiguous())
    return before.reshape(dt.shape), carry.reshape(trailing)


def wrapped_phase_cumsum(phase0, dt):
    """Phase accumulation ``phase[t] = wrap(phase0 + sum_{i<=t} dt[i])`` as
    a prefix sum (parallel; reassociates the adds, so it drifts from the
    per-sample order).  Returns (phase before each step ``[B, ...]``, final
    carry)."""
    csum = torch.cumsum(dt, dim=0)
    before = torch.cat([torch.zeros_like(csum[:1]), csum[:-1]]) + phase0
    before = before - torch.floor(before)
    carry = phase0 + csum[-1]
    carry = carry - torch.floor(carry)
    return before, carry
