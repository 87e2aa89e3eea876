"""The one generator of MIDI traffic: a mix file's parameters in, raw
note-on and note-off messages per block out.

A mix (``traffic/<name>.json``) may hold:

- ``block_size``: samples a block; ``pipeline_depth``: blocks the host
  runs ahead of the readback;
- ``chord``: ``{"first_note", "span", "velocity"}``, one note-on for each
  voice ``i`` (note ``first_note + i % span``) at offset 0 of block 0;
- ``note_ons_per_s``: the rate of a Poisson process of note-ons (0: none);
  each note is held a lognormal time (``duration_s``: ``median``,
  ``sigma``, ``max``) and then gets its note-off; keys and velocities are
  rounded normal draws (``key``, ``velocity``: ``mean``, ``sd``, ``min``,
  ``max``); every event falls at its own sample offset inside its block;
  all of it drawn from the run's seed;
- ``warmup_s``: audio of the same traffic rendered before the window.

Events are generated ahead in chunks of :data:`CHUNK_S` seconds of audio.
Within a block the events are in time order, a note-on before a note-off
at the same sample, each kind in the order it was drawn.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

CHUNK_S = 8.0
NOTE_ON, NOTE_OFF = 0x90, 0x80


def rng_of(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for any whole-number seed (negative and above 2**63
    included) and a stream number, so that one seed gives independent
    draws to independent uses."""
    return np.random.default_rng([int(seed) % (1 << 64), int(stream)])


class Traffic:
    """The events of one run: ``block(i)`` gives block ``i``'s messages as
    ``(offset, status, note, velocity)`` tuples, in the order the host
    queues them.  ``block`` may be asked again for any block already made
    (the reference reads the same messages)."""

    def __init__(self, mix: dict, seed: int, sample_rate: float, voices: int):
        self.mix = mix
        self.B = int(mix["block_size"])
        self.sr = float(sample_rate)
        self.voices = int(voices)
        self.rate = float(mix.get("note_ons_per_s", 0.0))
        # generated events up to sample self._horizon, sorted
        self._t = np.zeros(0, np.int64)
        self._status = np.zeros(0, np.int64)
        self._note = np.zeros(0, np.int64)
        self._vel = np.zeros(0, np.int64)
        self._horizon = 0
        self._pending = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        chord = mix.get("chord")
        if chord:
            n = self.voices
            self._t = np.zeros(n, np.int64)
            self._status = np.full(n, NOTE_ON, np.int64)
            self._note = (chord["first_note"]
                          + np.arange(n) % chord["span"]).astype(np.int64)
            self._vel = np.full(n, int(chord["velocity"]), np.int64)
        if self.rate > 0:
            self._rng = rng_of(seed, 1)
            self._next_on = self._interval()

    @property
    def warmup_blocks(self) -> int:
        """Blocks rendered before the window: the first block and
        ``warmup_s`` of audio, at least 3 (the first block, a steady key's
        eager warm-up and its capture)."""
        n = math.ceil(float(self.mix.get("warmup_s", 0.0)) * self.sr / self.B)
        return max(3, n)

    def _interval(self) -> float:
        return float(self._rng.exponential(self.sr / self.rate))

    def _normal(self, p: dict, n: int) -> np.ndarray:
        """``n`` rounded normal draws of ``p``, clipped to its range."""
        return np.clip(np.rint(self._rng.normal(p["mean"], p["sd"], n)),
                       p["min"], p["max"]).astype(np.int64)

    def _extend(self, until: int) -> None:
        """Generate every event before sample ``until`` (a whole number of
        chunks past the current horizon)."""
        chunk = int(CHUNK_S * self.sr)
        d = self.mix.get("duration_s", {})
        while self._horizon < until:
            end = self._horizon + chunk
            on_t = []
            while self.rate > 0 and self._next_on < end:
                on_t.append(int(self._next_on))
                self._next_on += self._interval()
            n = len(on_t)
            on_t = np.asarray(on_t, np.int64)
            if n:
                dur = np.minimum(self._rng.lognormal(
                    math.log(d["median"]), d["sigma"], n), d["max"])
                keys = self._normal(self.mix["key"], n)
                vels = self._normal(self.mix["velocity"], n)
                off_t = on_t + np.maximum(np.rint(dur * self.sr), 1)
            else:
                keys = vels = off_t = np.zeros(0)
            keys = keys.astype(np.int64)
            pend_t = np.concatenate([self._pending[0],
                                     off_t.astype(np.int64)])
            pend_k = np.concatenate([self._pending[1], keys])
            due = pend_t < end
            t = np.concatenate([on_t, pend_t[due]])
            st = np.concatenate([np.full(n, NOTE_ON), np.full(
                int(due.sum()), NOTE_OFF)]).astype(np.int64)
            nt = np.concatenate([keys, pend_k[due]])
            vl = np.concatenate([vels.astype(np.int64),
                                 np.zeros(int(due.sum()), np.int64)])
            # time order; at one sample note-ons first, each kind in the
            # order it was drawn
            order = np.lexsort((np.arange(len(t)), st != NOTE_ON, t))
            self._t = np.concatenate([self._t, t[order]])
            self._status = np.concatenate([self._status, st[order]])
            self._note = np.concatenate([self._note, nt[order]])
            self._vel = np.concatenate([self._vel, vl[order]])
            self._pending = (pend_t[~due], pend_k[~due])
            self._horizon = end

    def block(self, i: int) -> List[Tuple[int, int, int, int]]:
        lo, hi = i * self.B, (i + 1) * self.B
        if hi > self._horizon:
            self._extend(hi)
        a, b = np.searchsorted(self._t, [lo, hi])
        return list(zip((self._t[a:b] - lo).tolist(),
                        self._status[a:b].tolist(),
                        self._note[a:b].tolist(), self._vel[a:b].tolist()))
