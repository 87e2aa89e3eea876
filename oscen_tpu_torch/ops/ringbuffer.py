"""Functional ring buffer with linear and cubic fractional reads.

Counterpart of ``oscen_tpu/ops/ringbuffer.py`` (the reference RingBuffer,
ring_buffer/mod.rs): power-of-two capacity with mask wrapping, the
near-integer snap at 1e-6, Catmull-Rom cubic interpolation for fractional
offsets.  The buffer is a 1-D tensor in the state; reads are gathers
(``torch.take``) and writes scatters, both with index tensors computed on
the buffer's device, so nothing is read back to the host.  Every read
position may differ per sample (a ``[B]`` ``write_pos`` and ``offset``),
and a leading instance axis holds one ring per instance (a ``Delay`` node
array).  :func:`rb_push` writes out of place; :func:`rb_push_` writes in
place, for the per-sample loops that copy the ring once per run.
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


_ROWS: dict = {}


def _rows(buf, like):
    """Flat offsets of ``buf``'s rows, shaped to broadcast against index
    tensors shaped like ``like``: a ring per instance (``buf`` ``[C,
    cap]``, ``like`` ``[C, ...]``) reads and writes its own row.  None for
    a single ring.  Built once per shape and device."""
    lead = tuple(buf.shape[:-1])
    if not lead:
        return None
    key = (lead, buf.shape[-1], like.dim(), str(buf.device))
    rows = _ROWS.get(key)
    if rows is None:
        n = 1
        for d in lead:
            n *= d
        rows = (torch.arange(n, dtype=torch.int64, device=buf.device)
                * buf.shape[-1]).reshape(
                    lead + (1,) * (like.dim() - len(lead)))
        _ROWS[key] = rows
    return rows


def _take(buf, rows, idx):
    """``buf`` at the in-ring indices ``idx`` (of each instance's row)."""
    idx = idx.long()
    return torch.take(buf, idx if rows is None else rows + idx)


def rb_push(buf, write_pos, v):
    """Write ``v`` at ``write_pos`` and advance with the mask wrap
    (reference :57-76), out of place.  ``buf`` may carry a leading
    instance axis (``[C, cap]`` with ``write_pos`` and ``v`` ``[C]``): each
    instance writes its own ring, as the JAX package's
    ``buf.at[..., write_pos]`` does under ``vmap``."""
    return _push(buf.clone(), write_pos, v)


def rb_push_(buf, write_pos, v):
    """:func:`rb_push` into ``buf`` itself, in place: the per-sample loops
    copy the ring once per run and then write one sample at a time (a copy
    per sample would move the whole ring, 512 KB for the echo's, every
    sample).  Returns ``(buf, write_pos')``."""
    return _push(buf, write_pos, v)


def _push(buf, write_pos, v):
    cap = buf.shape[-1]
    rows = _rows(buf, write_pos)
    idx = write_pos.long()
    idx = (idx if rows is None else rows + idx).reshape(-1)
    v = torch.as_tensor(v, dtype=buf.dtype, device=buf.device)
    buf.view(-1).index_put_((idx,), v.expand(write_pos.shape).reshape(-1))
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
    broadcast; the result has their shape.  A ring per instance (``buf``
    ``[C, cap]``) takes ``write_pos`` and ``offset`` with a leading ``[C]``
    axis."""
    cap = buf.shape[-1]
    mask = cap - 1
    off = torch.clamp_min(offset, 0.0)
    frac_raw = off - torch.floor(off)

    # near-integer snap (reference :178-191)
    snap = torch.logical_or(frac_raw < 1e-6, (1.0 - frac_raw) < 1e-6)
    off_int = torch.round(off).to(torch.int32)
    snap_idx = ((write_pos + cap) - torch.remainder(off_int, cap) - 1) & mask
    rows = _rows(buf, snap_idx)
    snapped = _take(buf, rows, snap_idx)

    # Catmull-Rom cubic (reference :121-164)
    rp = _read_pos(write_pos, off, cap)
    i = rp.to(torch.int32)
    f = rp - torch.floor(rp)
    v0 = _take(buf, rows, (i - 1) & mask)
    v1 = _take(buf, rows, i & mask)
    v2 = _take(buf, rows, (i + 1) & mask)
    v3 = _take(buf, rows, (i + 2) & mask)
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
    rows = _rows(buf, i)
    a = _take(buf, rows, i & mask)
    b = _take(buf, rows, (i + 1) & mask)
    return a * (1.0 - f) + b * f
