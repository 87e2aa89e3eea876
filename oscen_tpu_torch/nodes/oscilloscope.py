"""Oscilloscope — the observability tap.

Counterpart of ``oscen_tpu/nodes/oscilloscope.py`` (the reference
Oscilloscope, oscilloscope/mod.rs): a pass-through node writing into a ring
that a UI reads via ``snapshot``, with zero-crossing trigger alignment
(manual period or auto-detect).

The ring lives in the state on the device; ``snapshot`` runs on the host
between blocks and reads the card by design, off the render path.

Auto-detect parity (reference :236-287): the reference counts samples
between rising zero crossings per sample, clamps the measured distance to
[10, capacity] as the display period, and (re)stores a triggered window at
every crossing.  The block path reproduces that state machine with
reductions over the block: within a block two adjacent crossings are
impossible (a rising crossing forces the next prev > 0), so the final
detected period is the distance between the last two crossings — or the
carried count + first-crossing offset when the block holds just one.

A block longer than the ring writes only its last ``capacity`` samples,
which is what the per-sample ring holds after the block (the JAX package's
``ring.at[idx].set(x)`` scatters duplicate indices there, and on CUDA
``index_put_`` with duplicates has no defined order).  Every method
broadcasts over a leading instance axis.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.types import SampleRate, stream
from ..graph.node import Node

DEFAULT_CAPACITY = 4096
MIN_PERIOD = 10  # reference clamp floor (oscilloscope/mod.rs:261)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Oscilloscope(Node):
    INPUTS = (stream("input", 0.0),)
    OUTPUTS = (stream("output"),)
    BATCHED = True

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)

    def init_state(self, sr: SampleRate):
        i32 = torch.int32
        return {"ring": torch.zeros((self.capacity,)),
                "write_pos": torch.tensor(0, dtype=i32),
                "last_sample": torch.tensor(0.0),
                "period_count": torch.tensor(0, dtype=i32),
                "detected_period": torch.tensor(0, dtype=i32),
                # ring position one past the most recent trigger crossing
                "trig_end": torch.tensor(-1, dtype=i32)}

    def _trigger_update(self, state, x, B):
        """Replay the reference's per-sample period detector over a block
        ``x [..., B]`` (count samples between rising crossings; clamp to
        [10, capacity]; store a triggered window at each crossing)."""
        prevs = torch.cat([state["last_sample"][..., None], x[..., :-1]],
                          dim=-1)
        cross = torch.logical_and(prevs <= 0.0, x > 0.0)
        idx = torch.arange(B, dtype=torch.int32, device=x.device)
        any_cross = torch.any(cross, dim=-1)
        neg = torch.full((), -1, dtype=torch.int32, device=x.device)
        t_last = torch.amax(torch.where(cross, idx, neg), dim=-1)
        t_first = torch.amin(torch.where(
            cross, idx, torch.full((), B, dtype=torch.int32,
                                   device=x.device)), dim=-1)
        # distance recorded at the last crossing: between the last two
        # crossings, or carried count + offset when only one in the block
        t_prev = torch.amax(torch.where(
            torch.logical_and(cross, idx < t_last[..., None]), idx, neg),
            dim=-1)
        first_dist = state["period_count"] + t_first + 1
        last_dist = torch.where(t_prev >= 0, t_last - t_prev, first_dist)
        detected = torch.where(
            torch.logical_and(any_cross, last_dist > 1),
            torch.clamp(last_dist, MIN_PERIOD, self.capacity),
            state["detected_period"]).to(torch.int32)
        count = torch.where(any_cross, B - 1 - t_last,
                            state["period_count"] + B).to(torch.int32)
        trig_end = torch.where(
            torch.logical_and(any_cross, detected > 0),
            torch.remainder(state["write_pos"] + t_last + 1, self.capacity),
            state["trig_end"]).to(torch.int32)
        return {"last_sample": x[..., B - 1], "period_count": count,
                "detected_period": detected, "trig_end": trig_end}

    def _write(self, state, x, B):
        """The ring after writing the block ``x [..., B]``: its last
        ``min(B, capacity)`` samples, one scatter without duplicates."""
        cap = self.capacity
        k = min(B, cap)
        idx = torch.remainder(
            state["write_pos"][..., None] + (B - k)
            + torch.arange(k, dtype=torch.int32, device=x.device), cap)
        ring = state["ring"].scatter(-1, idx.to(torch.int64), x[..., B - k:])
        wp = torch.remainder(state["write_pos"] + B, cap)
        return ring, wp

    def tick(self, state, ins, sr):
        x = ins["input"]
        ring, wp = self._write(state, x[..., None], 1)
        trig = self._trigger_update(state, x[..., None], 1)
        return {**state, **trig, "ring": ring, "write_pos": wp}, \
            {"output": x}

    def process_block(self, state, ins, events, sr, block_len):
        x = ins["input"]
        ring, wp = self._write(state, x, block_len)
        trig = self._trigger_update(state, x, block_len)
        return {**state, **trig, "ring": ring, "write_pos": wp}, \
            {"output": x}

    # ------------------------------------------------------------------ #
    @staticmethod
    def snapshot(state, length: Optional[int] = None,
                 trigger: bool = True,
                 period: Optional[int] = None) -> np.ndarray:
        """Host-side snapshot of the ring (reads the card: call it between
        blocks, off the render path).

        ``trigger=True`` returns the triggered display window: the
        ``period`` (manual) or auto-detected-period (reference
        :244-270) samples ending at the most recent rising zero
        crossing.  ``length`` optionally overrides the window length;
        without a trigger yet (or ``trigger=False``) the most recent
        samples are returned.
        """
        ring = _host(state["ring"])
        wp = int(_host(state["write_pos"]))
        cap = len(ring)
        chron = np.concatenate([ring[wp:], ring[:wp]])  # oldest..newest

        trig_end = int(_host(state.get("trig_end", -1)))
        detected = int(_host(state.get("detected_period", 0)))
        win = int(period if period is not None
                  else (detected if detected > 0 else (length or cap)))
        win = max(min(win, cap), 1)
        if not trigger or trig_end < 0:
            return chron[-(length or win):]
        # ring position -> chronological index
        end_chron = (trig_end - wp) % cap
        if end_chron == 0:
            end_chron = cap
        start = max(end_chron - win, 0)
        out = chron[start:end_chron]
        if length is not None:
            out = out[-length:] if len(out) >= length \
                else chron[max(end_chron - length, 0):end_chron]
        return out
