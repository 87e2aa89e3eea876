"""Polyphonic voice allocation — host-domain control node.

Copy of ``oscen_tpu/nodes/voice_allocator.py`` (host only): the
reference's CMajor-style LRU VoiceAllocator (oscen-lib/src/voice_allocator.rs): free voice first, else
steal preferring released-then-oldest; released voices stay active through
their release phase.  Control logic at event rate → runs on the host per
block; its ``voices`` event-output array demuxes note events onto the
per-voice gate endpoints of a device node array (the 256-voice instance axis).
"""

from __future__ import annotations

from typing import List

from ..core.events import EventInstance, NoteOffEvent, NoteOnEvent
from ..core.types import event
from ..graph.node import HostNode

MAX_VOICES = 4096  # reference caps at 24 (voice_allocator.rs:5); voices
# are the instance axis here (256+ per card).


class _VoiceState:
    __slots__ = ("active", "released", "note", "age", "released_at")

    def __init__(self):
        self.active = False
        self.released = False
        self.note = None
        self.age = 0
        self.released_at = None  # frame clock at release (for busy())


class VoiceAllocator(HostNode):
    INPUTS = (event("note_on"), event("note_off"))
    OUTPUTS = (event("voices"),)  # array event output [num_voices]

    def __init__(self, num_voices: int):
        if not (1 <= num_voices <= MAX_VOICES):
            raise ValueError(f"num_voices must be in 1..{MAX_VOICES}")
        self.num_voices = int(num_voices)
        self.reset()

    def reset(self):
        self._state = [_VoiceState() for _ in range(self.num_voices)]
        self._age = 0
        self._frames = 0  # block-resolution frame clock

    # ------------------------------------------------------------------ #
    def allocate_voice(self, note: int) -> int:
        """Free voice first, else steal released-then-oldest
        (reference :57-89)."""
        for i, v in enumerate(self._state):
            if not v.active:
                v.active, v.released, v.note, v.age = True, False, note, \
                    self._age
                v.released_at = None
                self._age += 1
                return i
        stolen = min(
            range(self.num_voices),
            key=lambda i: (0 if self._state[i].released else 1,
                           self._state[i].age))
        v = self._state[stolen]
        v.active, v.released, v.note, v.age = True, False, note, self._age
        v.released_at = None
        self._age += 1
        return stolen

    def find_voice_for_note(self, note: int):
        for i, v in enumerate(self._state):
            if v.active and not v.released and v.note == note:
                return i
        return None

    def release_voice(self, i: int) -> None:
        """Mark released but keep active through the release phase
        (reference :101-107)."""
        if 0 <= i < self.num_voices:
            self._state[i].released = True
            self._state[i].note = None
            self._state[i].released_at = self._frames

    # ------------------------------------------------------------------ #
    def host_state(self):
        """Only the mutable LRU tables — ``num_voices`` is constructor
        config and is validated (not overwritten) on restore."""
        import copy
        return {"num_voices": self.num_voices,
                "_state": copy.deepcopy(self._state),
                "_age": self._age, "_frames": self._frames}

    def restore_host_state(self, snapshot) -> None:
        import copy
        n = snapshot.get("num_voices", len(snapshot["_state"]))
        if n != self.num_voices:
            raise ValueError(
                f"checkpointed allocator has {n} voices, this graph has "
                f"{self.num_voices}")
        self._state = copy.deepcopy(snapshot["_state"])
        self._age = snapshot["_age"]
        self._frames = snapshot.get("_frames", 0)

    # ------------------------------------------------------------------ #
    def host_process(self, block_len, events_in, values_in):
        voices: List[List[EventInstance]] = [
            [] for _ in range(self.num_voices)]
        merged = []
        for i, ev in enumerate(events_in.get("note_on", [])):
            merged.append((ev.frame_offset, 0, i, "on", ev))
        for i, ev in enumerate(events_in.get("note_off", [])):
            merged.append((ev.frame_offset, 1, i, "off", ev))
        merged.sort(key=lambda x: (x[0], x[1], x[2]))
        for off, _, _, kind, ev in merged:
            if kind == "on" and isinstance(ev.payload, NoteOnEvent):
                idx = self.allocate_voice(ev.payload.note)
                voices[idx].append(ev)
            elif kind == "off" and isinstance(ev.payload, NoteOffEvent):
                idx = self.find_voice_for_note(ev.payload.note)
                if idx is not None:
                    voices[idx].append(ev)
                    self.release_voice(idx)
        self._frames += int(block_len)
        return {"voices": voices}, {}

    # ------------------------------------------------------------------ #
    # conservative voice-activity classes (utils/voice_classes.py)
    # ------------------------------------------------------------------ #
    def busy_mask(self, tail_frames: int) -> List[bool]:
        """Per-voice conservative liveness: a voice is busy while holding
        a note, and for ``tail_frames`` after its release (the worst-case
        release tail).  Needs no device sync — everything is host-side
        control state (the reference keeps released voices "active" until
        stolen for the same reason, voice_allocator.rs:101-107)."""
        out = []
        for v in self._state:
            if not v.active:
                out.append(False)
            elif not v.released or v.released_at is None:
                out.append(True)
            else:
                out.append(self._frames - v.released_at < tail_frames)
        return out

    def permute(self, perm: List[int]) -> None:
        """Reorder voice slots (class-switch compaction); ``perm[i]`` is
        the old index now living at slot i."""
        assert sorted(perm) == list(range(self.num_voices))
        self._state = [self._state[p] for p in perm]
