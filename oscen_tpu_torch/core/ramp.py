"""Host-side linear parameter ramps.

Copy of ``oscen_tpu/core/ramp.py`` (numpy): the reference's
``ValueRampState`` (graph/types.rs:299-373).  Ramps are control-rate state
that lives on the host; each block the ramp is materialized into a
per-sample ``[B]`` float32 array staged to the device, so the device sees exactly the per-sample values the reference's
``tick()`` would produce (bit-exact f32 accumulation, including the
land-exactly-on-target completion).
"""

from __future__ import annotations

import numpy as np


class ValueRampState:
    def __init__(self, initial: float = 0.0):
        self.current = np.float32(initial)
        self.target = np.float32(initial)
        self.increment = np.float32(0.0)
        self.frames_remaining = 0
        # False until ANY setter runs: a never-touched parameter still
        # holds its compile-time default, so the block compiler may
        # stage it as a TRACE-TIME LITERAL (folded into the program like
        # an unconnected node default) instead of a runtime [1] operand.
        # The first setter flips it, restaging the parameter as runtime
        # data (one bounded retrace — the same class as the idle-[1] vs
        # ramping-[B] shape split).
        self.touched = False

    def set_immediate(self, v: float) -> None:
        self.touched = True
        self.current = np.float32(v)
        self.target = np.float32(v)
        self.increment = np.float32(0.0)
        self.frames_remaining = 0

    def set_with_ramp(self, target: float, frames: int) -> None:
        self.touched = True
        if frames == 0:
            self.set_immediate(target)
        else:
            self.target = np.float32(target)
            self.increment = np.float32(
                (np.float32(target) - self.current) / np.float32(frames))
            self.frames_remaining = int(frames)

    def tick(self) -> bool:
        """Advance one frame; returns True when the ramp just completed."""
        if self.frames_remaining > 0:
            self.frames_remaining -= 1
            if self.frames_remaining == 0:
                self.current = self.target
                self.increment = np.float32(0.0)
                return True
            self.current = np.float32(self.current + self.increment)
        return False

    @property
    def is_ramping(self) -> bool:
        return self.frames_remaining > 0

    def materialize_block(self, block_len: int) -> np.ndarray:
        """Tick ``block_len`` times, returning the per-sample values.

        Sample ``t`` holds the value after the ``t+1``-th tick — the value a
        node reads at that sample in the reference's schedule (ramps tick at
        the top of ``__advance_one_frame``, codegen/mod.rs:906-913).

        An idle ramp returns a LENGTH-1 array: the block function
        broadcasts it lazily and treats the parameter as block-constant
        (``const_eps`` in graph/block_mode.py), so nodes may skip their
        per-sample parameter-change paths.
        """
        if self.frames_remaining == 0:
            return np.full((1,), self.current, np.float32)
        out = np.empty((block_len,), np.float32)
        for t in range(block_len):
            self.tick()
            out[t] = self.current
        return out
