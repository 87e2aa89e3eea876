"""Functional ring buffer with linear and cubic fractional reads.

Counterpart of ``oscen_tpu/ops/ringbuffer.py`` (the reference RingBuffer,
ring_buffer/mod.rs): power-of-two capacity with mask wrapping, the
near-integer snap at 1e-6, Catmull-Rom cubic interpolation for fractional
offsets.  The buffer is a 1-D tensor in the state; reads are gathers
(``torch.take``) and writes out-of-place scatters, both with index tensors
computed on the buffer's device, so nothing is read back to the host.
Every read position may differ per sample (a ``[B]`` ``write_pos`` and
``offset``).
"""

from __future__ import annotations

import torch


def next_power_of_two(n: int) -> int:
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def rb_new(size: int):
    """A zeroed power-of-two ring buffer and its write position."""
    cap = next_power_of_two(size)
    return (torch.zeros((cap,), dtype=torch.float32),
            torch.tensor(0, dtype=torch.int32))


def rb_push(buf, write_pos, v):
    """Write ``v`` at ``write_pos`` and advance with the mask wrap
    (reference :57-76)."""
    cap = buf.shape[-1]
    idx = write_pos.reshape(1).long()
    buf = buf.index_put((idx,), torch.as_tensor(v, dtype=buf.dtype,
                                                device=buf.device).reshape(1))
    return buf, (write_pos + 1) & (cap - 1)


def _mod(x, n: float):
    """``jnp.mod`` for a positive divisor: the truncated remainder (exact),
    moved into ``[0, n)``."""
    r = torch.fmod(x, n)
    return torch.where(r < 0, r + n, r)


def _read_pos(write_pos, offset, cap: int):
    """Float read index for ``offset`` samples into the past
    (reference :80-91)."""
    n = float(cap)
    rp = write_pos.to(torch.float32) - offset - 1.0
    return _mod(_mod(rp, n) + n, n)


def rb_get(buf, write_pos, offset):
    """Read ``offset`` samples into the past (0 = most recent), with the
    reference's near-integer snap and Catmull-Rom interpolation
    (reference :121-201).  ``write_pos`` (int32) and ``offset`` (float32)
    broadcast; the result has their shape."""
    cap = buf.shape[-1]
    mask = cap - 1
    off = torch.clamp_min(offset, 0.0)
    frac_raw = off - torch.floor(off)

    # near-integer snap (reference :178-191)
    snap = torch.logical_or(frac_raw < 1e-6, (1.0 - frac_raw) < 1e-6)
    off_int = torch.round(off).to(torch.int32)
    snap_idx = ((write_pos + cap) - torch.remainder(off_int, cap) - 1) & mask
    snapped = torch.take(buf, snap_idx.long())

    # Catmull-Rom cubic (reference :121-164)
    rp = _read_pos(write_pos, off, cap)
    i = rp.to(torch.int32)
    f = rp - torch.floor(rp)
    v0 = torch.take(buf, ((i - 1) & mask).long())
    v1 = torch.take(buf, (i & mask).long())
    v2 = torch.take(buf, ((i + 1) & mask).long())
    v3 = torch.take(buf, ((i + 2) & mask).long())
    c0 = v1
    c1 = 0.5 * (v2 - v0)
    c2 = v0 - 2.5 * v1 + 2.0 * v2 - 0.5 * v3
    c3 = 0.5 * (v3 - v0) + 1.5 * (v1 - v2)
    cubic = c0 + f * (c1 + f * (c2 + f * c3))

    return torch.where(snap, snapped, cubic)


def rb_get_linear(buf, write_pos, offset):
    """Linear-interpolated read (reference :94-118), without the snap."""
    cap = buf.shape[-1]
    mask = cap - 1
    rp = _read_pos(write_pos, torch.clamp_min(offset, 0.0), cap)
    i = rp.to(torch.int32)
    f = rp - torch.floor(rp)
    a = torch.take(buf, (i & mask).long())
    b = torch.take(buf, ((i + 1) & mask).long())
    return a * (1.0 - f) + b * f
