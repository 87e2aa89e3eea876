"""Feedback delay line.

Counterpart of ``oscen_tpu/nodes/delay.py`` (the reference Delay,
delay/mod.rs): ``out = buf.get(delay_samples); buf.push(in + out *
feedback)`` over a power-of-two ring buffer sized to 2 s (capped at 88200
samples), parameters clamped every 32 frames.  It is the feedback-capable
node (``ALLOWS_FEEDBACK``, reference delay/mod.rs:85).

The per-sample :meth:`Delay.tick` is the JAX package's: read with the
snap / Catmull-Rom ``rb_get``, then push ``input + delayed * feedback``.
It broadcasts over a leading instance axis (a node array of delays keeps
one ring per instance, ``[C, cap]``).  Inside a per-sample loop the ring
is copied once per run (:meth:`own_state`) and written in place
(:meth:`tick_owned`, ``rb_push_``).

Block paths, both resting on a static ``min_delay`` promise:

- ``process_block``: the feedback recurrence has a lag of at least
  ``min_delay`` samples, so the block runs in chunks of ``min_delay - 4``
  samples, each one vectorized gather and one scatter (a Python loop over
  the chunks);
- ``block_read`` / ``block_write``: with ``min_delay >= B + 4`` the block
  compiler dissolves a feedback island around the delay
  (``graph/block_mode.py``): the whole block is read first, the rest of
  the island runs, and the block is written last.

Without the promise, with chunks under 8 samples or with a block shorter
than a chunk, ``process_block`` scans the tick, as the JAX package does.
"""

from __future__ import annotations

import torch

from ..core.types import SampleRate, stream, value
from ..graph.node import Node
from ..ops.ringbuffer import rb_get, rb_new, rb_push, rb_push_

MAX_DELAY_SAMPLES = 88200
FRAMES_PER_UPDATE = 32


class Delay(Node):
    ALLOWS_FEEDBACK = True

    INPUTS = (stream("input", 0.0), value("delay_samples", 0.0),
              value("feedback", 0.0))
    OUTPUTS = (stream("output"),)

    def __init__(self, delay_samples: float = 0.0, feedback: float = 0.0,
                 min_delay: int = 0):
        """``min_delay`` (static, optional): a promise that the effective
        delay never drops below this many samples.  It unlocks the block
        paths (delay values are clamped to honor it)."""
        self.INPUTS = (stream("input", 0.0),
                       value("delay_samples", float(delay_samples)),
                       value("feedback", float(feedback)))
        self.min_delay = int(min_delay)

    @classmethod
    def from_seconds(cls, delay_seconds: float, feedback: float,
                     sample_rate: float) -> "Delay":
        return cls(delay_seconds * sample_rate, feedback)

    def init_state(self, sr: SampleRate):
        buf, wp = rb_new(min(int(2.0 * sr.hz), MAX_DELAY_SAMPLES))
        return {"buf": buf, "write_pos": wp,
                "frame_counter": torch.tensor(0, dtype=torch.int32)}

    @staticmethod
    def _clamp_cadence(update, delay_in, fb_in, cap: int):
        """The reference clamps the parameters only on update frames
        (frame_counter == 0, every 32nd frame) and passes raw values
        between updates (delay/mod.rs:47-55); ``update`` is a per-sample
        mask."""
        delay = torch.where(update, torch.clamp(delay_in, 0.0, float(cap - 1)),
                            delay_in)
        fb = torch.where(update, torch.clamp(fb_in, 0.0, 0.99), fb_in)
        return delay, fb

    def _block_params(self, state, ins, block_len: int):
        """Per-sample effective parameters for a block, replaying the
        32-frame clamp cadence from the carried frame counter."""
        offs = torch.arange(block_len, dtype=torch.int32,
                            device=state["buf"].device)
        update = (state["frame_counter"] + offs) % FRAMES_PER_UPDATE == 0
        delay, fb = self._clamp_cadence(update, ins["delay_samples"],
                                        ins["feedback"],
                                        state["buf"].shape[-1])
        if self.min_delay:
            delay = torch.clamp_min(delay, float(self.min_delay))
        return delay, fb

    def _tick(self, state, ins, push):
        """One sample (JAX ``tick``): the parameters clamped on the
        32-frame cadence, the read, then the push of ``input + delayed *
        feedback``."""
        delay, fb = self._clamp_cadence(
            state["frame_counter"] == 0, ins["delay_samples"],
            ins["feedback"], state["buf"].shape[-1])
        counter = (state["frame_counter"] + 1) % FRAMES_PER_UPDATE
        if self.min_delay:
            delay = torch.clamp_min(delay, float(self.min_delay))
        delayed = rb_get(state["buf"], state["write_pos"], delay)
        buf, wp = push(state["buf"], state["write_pos"],
                       ins["input"] + delayed * fb)
        return ({"buf": buf, "write_pos": wp, "frame_counter": counter},
                {"output": delayed})

    def tick(self, state, ins, sr):
        return self._tick(state, ins, rb_push)

    def own_state(self, state):
        return {**state, "buf": state["buf"].clone()}

    def tick_owned(self, state, ins, sr):
        return self._tick(state, ins, rb_push_)

    @staticmethod
    def _advance(state, buf, block_len: int):
        cap = buf.shape[-1]
        return {"buf": buf,
                "write_pos": (state["write_pos"] + block_len) & (cap - 1),
                "frame_counter": (state["frame_counter"] + block_len)
                % FRAMES_PER_UPDATE}

    # ------------------------------------------------------------------ #
    # island dissolution (graph/block_mode.py): with min_delay >= B + 4
    # every read of the block addresses pre-block buffer contents
    # ------------------------------------------------------------------ #
    def block_read(self, state, ins, block_len: int, literal_ins=None):
        """The whole block's delayed output from the carried ring buffer;
        valid only under the ``min_delay >= B + 4`` promise.

        When ``delay_samples`` is a literal of the compiled graph (an
        unconnected default or a ``Const``: the simple echo), in range and
        integral after the min-delay clamp, every sample reads the same
        integer offset, so the read is one contiguous gather of
        ``(s0 + arange(B)) & mask`` with ``s0`` computed on the device (the
        JAX package's ``dynamic_slice``; ``torch.narrow`` would need ``s0``
        on the host).  It equals the snap branch of ``rb_get`` it
        replaces."""
        delay, fb = self._block_params(state, ins, block_len)
        buf = state["buf"]
        cap = buf.shape[-1]
        offs = torch.arange(block_len, dtype=torch.int32, device=buf.device)
        d0 = (literal_ins or {}).get("delay_samples")
        if d0 is not None and 0.0 <= d0 <= cap - 1:
            D = max(float(d0), float(self.min_delay))
            if D == round(D):
                s0 = (state["write_pos"] - int(D) - 1) & (cap - 1)
                return torch.take(buf, ((s0 + offs) & (cap - 1)).long()), fb
        return rb_get(buf, state["write_pos"] + offs, delay), fb

    def block_write(self, state, x, delayed, fb, block_len: int):
        """Push the whole block (``input + delayed * feedback``)."""
        buf = state["buf"]
        offs = torch.arange(block_len, dtype=torch.int32, device=buf.device)
        idx = ((state["write_pos"] + offs) & (buf.shape[-1] - 1)).long()
        return self._advance(state, buf.index_put((idx,), x + delayed * fb),
                             block_len)

    def process_block(self, state, ins, events, sr, block_len):
        """Chunked block path (requires ``min_delay``): chunks of
        ``min_delay - 4`` samples (4 = the Catmull-Rom margin and the
        boundary) read only pre-chunk buffer contents.  Without the
        promise, with chunks under 8 samples or with a block shorter than a
        chunk, the per-sample tick scan."""
        chunk = self.min_delay - 4
        if chunk < 8 or block_len < chunk:
            return super().process_block(state, ins, events, sr, block_len)
        buf = state["buf"]
        mask = buf.shape[-1] - 1
        wp = state["write_pos"]
        x = ins["input"]
        delay, fb = self._block_params(state, ins, block_len)
        ys = []
        for s in range(0, block_len, chunk):
            n = min(chunk, block_len - s)
            wps = wp + torch.arange(n, dtype=torch.int32, device=buf.device)
            delayed = rb_get(buf, wps, delay[s:s + n])
            buf = buf.index_put(((wps & mask).long(),),
                                x[s:s + n] + delayed * fb[s:s + n])
            wp = (wp + n) & mask
            ys.append(delayed)
        return self._advance(state, buf, block_len), {"output": torch.cat(ys)}
