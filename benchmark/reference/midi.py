"""The control plane, written again from oscen's MIDI semantics: raw
messages parsed into note-ons and note-offs, voices allocated, each voice's
note tracked (oscen-lib ``midi.rs``, ``voice_allocator.rs``).

- A status 0x90 with velocity > 0 is a note-on at velocity / 127; 0x80, or
  0x90 with velocity 0, is a note-off.
- Within a block the events go in sample order, note-ons before note-offs
  at one offset, each kind in arrival order.
- A note-on takes the first voice never used, else steals the released
  voice that was allocated longest ago, else the voice allocated longest
  ago.  A released voice stays in use (its release tail sounds) until it
  is stolen.  A note-off releases the first held voice that plays its
  note; a note whose voice was stolen gets none.
- Each voice takes its note-ons and note-offs in that order; a note-on
  sets its frequency, 440 * 2^((note - 69) / 12), and gates it at the
  velocity; a note-off gates it at 0 if the voice still plays that note.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def note_frequency(note: int) -> float:
    return 440.0 * 2.0 ** ((note - 69) / 12.0)


class Voices:
    """The allocator and the per-voice note handlers of ``n`` voices.
    ``block(events)`` takes one block's raw ``(offset, status, note,
    velocity)`` messages and returns the voices' gate events,
    ``{voice: [(offset, gate value, frequency or None)]}``, where a gate
    value above 0 is a note-on's velocity and carries the new frequency."""

    def __init__(self, n: int):
        self.n = n
        self.used = [False] * n
        self.released = [False] * n
        self.note: List[object] = [None] * n      # the allocator's note
        self.age = [0] * n
        self.clock = 0
        self.playing: List[object] = [None] * n   # each handler's note
        self.frequency = [440.0] * n

    def _allocate(self, note: int) -> int:
        for i in range(self.n):
            if not self.used[i]:
                break
        else:
            i = min(range(self.n),
                    key=lambda j: (not self.released[j], self.age[j]))
        self.used[i], self.released[i] = True, False
        self.note[i], self.age[i] = note, self.clock
        self.clock += 1
        return i

    def block(self, events) -> Dict[int, List[Tuple[int, float, object]]]:
        ons, offs = [], []
        for off, status, note, vel in events:
            kind = status & 0xF0
            if kind == 0x90 and vel > 0:
                ons.append((off, note, min(max(vel / 127.0, 0.0), 1.0)))
            elif kind in (0x80, 0x90):
                offs.append((off, note))
        merged = sorted([(o, 0, i) for i, (o, _, _) in enumerate(ons)]
                        + [(o, 1, i) for i, (o, _) in enumerate(offs)])
        per_voice: Dict[int, List[Tuple[int, int, int, float]]] = {}
        for off, kind, i in merged:
            if kind == 0:
                _, note, vel = ons[i]
                v = self._allocate(note)
                per_voice.setdefault(v, []).append((off, 0, note, vel))
            else:
                note = offs[i][1]
                v = next((j for j in range(self.n) if self.used[j]
                          and not self.released[j]
                          and self.note[j] == note), None)
                if v is None:
                    continue
                per_voice.setdefault(v, []).append((off, 1, note, 0.0))
                self.released[v], self.note[v] = True, None
        gates: Dict[int, List[Tuple[int, float, object]]] = {}
        for v, evs in per_voice.items():
            out = []
            for off, kind, note, vel in sorted(
                    evs, key=lambda e: (e[0], e[1])):
                if kind == 0:
                    self.playing[v] = note
                    self.frequency[v] = note_frequency(note)
                    out.append((off, vel, self.frequency[v]))
                elif self.playing[v] == note:
                    self.playing[v] = None
                    out.append((off, 0.0, None))
            if out:
                gates[v] = out
        return gates
