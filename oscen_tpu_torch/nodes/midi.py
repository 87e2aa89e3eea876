"""MIDI parsing and per-voice note handling — host-domain control nodes.

Copy of ``oscen_tpu/nodes/midi.py`` (numpy, host only): the reference's
MidiParser / MidiVoiceHandler (oscen-lib/src/midi.rs).  These are
event-rate control nodes: in the reference they run in the event phase of
the audio callback; here they run on the host once per block (the
host↔device boundary is the control↔audio thread boundary), producing typed
events and per-sample value arrays staged to the device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.events import (EventInstance, NoteOffEvent, NoteOnEvent,
                           RawMidiMessage)
from ..core.types import event, value
from ..graph.node import HostNode, StepValue


def midi_note_to_freq(note: int) -> float:
    """440 * 2^((n-69)/12) (reference midi.rs:69-73)."""
    return float(440.0 * 2.0 ** ((float(note) - 69.0) / 12.0))


class MidiParser(HostNode):
    """Raw 3-byte MIDI → typed NoteOn/NoteOff events
    (reference midi.rs:125-225).  Note-on with velocity 0 is a note-off."""

    INPUTS = (event("midi_in"),)
    OUTPUTS = (event("note_on"), event("note_off"))

    @staticmethod
    def parse_bytes(data) -> object:
        if len(data) < 3:
            return None
        status = data[0] & 0xF0
        note, velocity = data[1], data[2]
        if status == 0x80:
            return NoteOffEvent(note)
        if status == 0x90:
            if velocity == 0:
                return NoteOffEvent(note)
            return NoteOnEvent(note, min(max(velocity / 127.0, 0.0), 1.0))
        return None

    def host_process(self, block_len, events_in, values_in):
        note_on: List[EventInstance] = []
        note_off: List[EventInstance] = []
        for ev in events_in.get("midi_in", []):
            payload = ev.payload
            if not isinstance(payload, RawMidiMessage):
                continue
            parsed = self.parse_bytes(payload.bytes)
            if isinstance(parsed, NoteOnEvent):
                note_on.append(EventInstance(ev.frame_offset, parsed))
            elif isinstance(parsed, NoteOffEvent):
                note_off.append(EventInstance(ev.frame_offset, parsed))
        return {"note_on": note_on, "note_off": note_off}, {}


class MidiVoiceHandler(HostNode):
    """Note events → frequency value output + gate scalar events
    (reference midi.rs:39-122).

    ``frequency`` is a *value output* that changes sample-accurately at the
    event frame; it is staged as a per-sample ``[B]`` step-function array.
    """

    INPUTS = (event("note_on"), event("note_off"))
    OUTPUTS = (value("frequency", 440.0), event("gate"))

    def __init__(self):
        self.current_note = None
        self.current_frequency = 440.0

    def reset(self):
        self.current_note = None
        self.current_frequency = 440.0

    def host_process(self, block_len, events_in, values_in):
        gate: List[EventInstance] = []
        # merge note_on/note_off streams in frame order (stable: ons first
        # at equal offsets, matching reference endpoint declaration order)
        merged: List[Tuple[int, int, EventInstance]] = []
        for i, ev in enumerate(events_in.get("note_on", [])):
            merged.append((ev.frame_offset, 0, i, "on", ev))
        for i, ev in enumerate(events_in.get("note_off", [])):
            merged.append((ev.frame_offset, 1, i, "off", ev))
        merged.sort(key=lambda x: (x[0], x[1], x[2]))

        # frequency output forms, cheapest first:
        #   no note-on            -> [1] block-constant array (const_eps
        #                            lets consumers hoist per-sample work)
        #   exactly one note-on   -> StepValue (staged as 3 scalars,
        #                            reconstructed to [B] on device — no
        #                            host-built/transferred [B] array;
        #                            see graph/node.py StepValue)
        #   several note-ons      -> host-built [B] array (rare)
        freq = None
        steps = []  # (offset, new_frequency)
        base_freq = self.current_frequency
        for off, _, _, kind, ev in merged:
            if kind == "on" and isinstance(ev.payload, NoteOnEvent):
                self.current_note = ev.payload.note
                self.current_frequency = midi_note_to_freq(ev.payload.note)
                if len(steps) >= 1 and freq is None:
                    # second step: materialize the fallback array
                    freq = StepValue(base_freq, steps[0][0],
                                     steps[0][1]).materialize(block_len)
                if freq is not None:
                    freq[min(off, block_len - 1):] = np.float32(
                        self.current_frequency)
                steps.append((off, self.current_frequency))
                gate.append(EventInstance(off, ev.payload.velocity))
            elif kind == "off" and isinstance(ev.payload, NoteOffEvent):
                if self.current_note == ev.payload.note:
                    gate.append(EventInstance(off, 0.0))
                    self.current_note = None
        if freq is None:
            if not steps:
                # block-constant: stage as a LENGTH-1 array — the block
                # function broadcasts it at entry and consumers (const_eps)
                # may hoist per-sample work
                freq = np.full((1,), np.float32(self.current_frequency),
                               np.float32)
            else:
                freq = StepValue(base_freq, steps[0][0], steps[0][1])
        return {"gate": gate}, {"frequency": freq}


class EventPassthrough(HostNode):
    """Forwards events in→out (reference event_passthrough.rs); the graph
    compiler uses it for graph-level event routing."""

    INPUTS = (event("input"),)
    OUTPUTS = (event("output"),)

    def host_process(self, block_len, events_in, values_in):
        return {"output": list(events_in.get("input", []))}, {}


def raw_midi_event(data) -> RawMidiMessage:
    """Helper to build a raw MIDI payload (reference midi.rs:228-230)."""
    return RawMidiMessage.new(data)
