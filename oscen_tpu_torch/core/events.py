"""Event types and the host↔device event representation.

Counterpart of ``oscen_tpu/core/events.py``.  Events live in two domains:

- **Host domain** (control logic in Python/NumPy per block): plain
  :class:`EventInstance` lists.  MidiParser, VoiceAllocator and
  MidiVoiceHandler operate on these, as the reference runs them in the
  event phase of ``process_block`` (codegen/mod.rs:754-872).
- **Device domain**: a dense, static-shape :class:`EventBuffer` per
  event-input endpoint — sorted ``offsets[..., K]``, scalar
  ``values[..., K]`` and a ``valid[..., K]`` mask, as numpy arrays while
  the host builds them and as tensors on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .types import MAX_STATIC_EVENTS_PER_ENDPOINT


@dataclass(frozen=True)
class NoteOnEvent:
    """Typed note-on payload (reference midi.rs:25-29)."""

    note: int
    velocity: float  # 0.0 - 1.0


@dataclass(frozen=True)
class NoteOffEvent:
    """Typed note-off payload (reference midi.rs:31-35)."""

    note: int


@dataclass(frozen=True)
class RawMidiMessage:
    """Raw (unparsed) MIDI bytes (reference midi.rs:7-22)."""

    bytes: tuple

    @staticmethod
    def new(data: Sequence[int]) -> "RawMidiMessage":
        return RawMidiMessage(tuple(int(b) for b in data[:3]))


@dataclass(frozen=True)
class EventInstance:
    """One event: sample-accurate offset within the block plus a payload
    (a float for scalar events, any object for object events)."""

    frame_offset: int
    payload: Any

    @property
    def scalar(self) -> float:
        """Scalar view of the payload (objects coerce to 1.0, matching
        reference adsr.rs:250-254)."""
        if isinstance(self.payload, (int, float)):
            return float(self.payload)
        return 1.0


def scalar_event(frame_offset: int, v: float) -> EventInstance:
    return EventInstance(int(frame_offset), float(v))


@dataclass
class EventBuffer:
    """Dense static-shape representation of one endpoint's events.

    ``offsets`` int32, ``values`` float32, ``valid`` bool, each ``[..., K]``
    (a leading instance axis for node arrays).  The reference caps events
    at 32 per endpoint per block (types.rs:18), so K <= 32 loses nothing.

    ``slots`` (optional) is the host's copy of where the events are:
    ``{t: (k, ...)}``, the slots ``k`` whose offset is ``t`` in at least
    one instance (``CompiledGraph`` fills it when it stages the buffer).
    The per-sample loops apply handlers only at those ``(t, k)`` pairs;
    without it they take the masked form over every slot.
    """

    offsets: Any
    values: Any
    valid: Any
    slots: Any = None

    @property
    def capacity(self) -> int:
        return int(self.offsets.shape[-1])

    @staticmethod
    def empty(capacity: int = 0) -> "EventBuffer":
        return EventBuffer(np.zeros((capacity,), np.int32),
                           np.zeros((capacity,), np.float32),
                           np.zeros((capacity,), bool))

    @staticmethod
    def from_events(events: Sequence[EventInstance],
                    capacity: Optional[int] = None) -> "EventBuffer":
        """Pack a host event list into a sorted dense numpy buffer (stable
        sort: push order survives within a frame, codegen/mod.rs:782-799;
        overflow beyond the cap is dropped, static_context.rs:86)."""
        evs = sorted(events, key=lambda e: e.frame_offset)
        evs = evs[:MAX_STATIC_EVENTS_PER_ENDPOINT]
        n = len(evs)
        capacity = n if capacity is None else max(capacity, n)
        off = np.zeros((capacity,), np.int32)
        val = np.zeros((capacity,), np.float32)
        ok = np.zeros((capacity,), bool)
        for i, e in enumerate(evs):
            off[i] = e.frame_offset
            val[i] = e.scalar
            ok[i] = True
        return EventBuffer(off, val, ok)

    @staticmethod
    def host_slots(offsets, valid) -> Dict[int, Tuple[int, ...]]:
        """``{t: (k, ...)}`` of a numpy buffer: every slot ``k`` valid at
        offset ``t`` in some instance, in slot order."""
        ok = np.asarray(valid)
        if not ok.any():
            return {}
        off = np.asarray(offsets).reshape(-1, ok.shape[-1])
        ok = ok.reshape(off.shape)
        out: Dict[int, set] = {}
        for r, k in zip(*np.nonzero(ok)):
            out.setdefault(int(off[r, k]), set()).add(int(k))
        return {t: tuple(sorted(ks)) for t, ks in sorted(out.items())}

    @staticmethod
    def stack(buffers: Sequence["EventBuffer"]) -> "EventBuffer":
        """Stack per-instance buffers into a leading instance axis (node
        arrays, per-voice event demux), padded to the largest capacity."""
        cap = max((b.capacity for b in buffers), default=0)
        padded = [b.pad_to(cap) for b in buffers]
        if padded and isinstance(padded[0].offsets, torch.Tensor):
            return EventBuffer(*(torch.stack([getattr(b, f) for b in padded])
                                 for f in ("offsets", "values", "valid")))
        return EventBuffer(*(np.stack([np.asarray(getattr(b, f))
                                       for b in padded])
                             for f in ("offsets", "values", "valid")))

    def pad_to(self, capacity: int) -> "EventBuffer":
        """The buffer with ``capacity`` slots; the new ones are invalid."""
        k = self.capacity
        if k == capacity:
            return self
        if k > capacity:
            raise ValueError("cannot shrink EventBuffer")
        if isinstance(self.offsets, torch.Tensor):
            return EventBuffer(*(torch.nn.functional.pad(x, (0, capacity - k))
                                 for x in (self.offsets, self.values,
                                           self.valid)))
        pw = [(0, 0)] * (np.ndim(self.offsets) - 1) + [(0, capacity - k)]
        return EventBuffer(*(np.pad(np.asarray(x), pw)
                             for x in (self.offsets, self.values,
                                       self.valid)))


@dataclass
class EventQueue:
    """Host-side event queue of the host-domain control nodes: the
    reference's ``EventInput``/``EventOutput`` ArrayVec queues
    (types.rs:136-241), which drop what overflows the capacity."""

    events: List[EventInstance] = field(default_factory=list)
    capacity: int = MAX_STATIC_EVENTS_PER_ENDPOINT

    def try_push(self, ev: EventInstance) -> bool:
        if len(self.events) >= self.capacity:
            return False  # dropped, like the reference's try_push
        self.events.append(ev)
        return True

    def clear(self) -> None:
        self.events.clear()

    def __iter__(self):
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)
