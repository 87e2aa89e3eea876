"""Electric piano — the flagship benchmark model.

Counterpart of ``oscen_tpu/models/electric_piano.py``: the reference
example (examples/electric-piano/src/main.rs:33-97): raw MIDI →
parser → voice allocator → per-voice handlers → N additive voices
(AmplitudeSource → OscillatorBank, electric_piano_voice.rs:362-403) →
fan-in mix → stereo tremolo.  The reference runs 16 voices on a CPU; the
voice axis here is the instance axis of one kernel launch per steady block
(256 voices on one card at the flagship).
"""

from __future__ import annotations

from ..graph.builder import Graph
from ..nodes.basic import Tremolo
from ..nodes.electric_piano import AmplitudeSource, OscillatorBank
from ..nodes.midi import MidiParser, MidiVoiceHandler
from ..nodes.voice_allocator import VoiceAllocator


def build_voice() -> Graph:
    """ElectricPianoVoiceNode (electric_piano_voice.rs:362-403)."""
    g = Graph("ElectricPianoVoice")
    g.input("frequency", "value", default=440.0)
    g.input("gate", "event")
    g.input("brightness", "value", default=30.0)
    g.input("velocity_scaling", "value", default=50.0)
    g.input("decay_rate", "value", default=90.0)
    g.input("harmonic_decay", "value", default=70.0)
    g.input("key_scaling", "value", default=50.0)
    g.input("release_rate", "value", default=40.0)
    g.output("output", "stream")

    amp = g.add("amplitude_source", AmplitudeSource())
    bank = g.add("oscillator_bank", OscillatorBank())

    for p in ("frequency", "brightness", "velocity_scaling", "decay_rate",
              "harmonic_decay", "key_scaling", "release_rate"):
        g.connect(p, f"amplitude_source.{p}" if p != "frequency"
                  else amp.frequency)
    g.connect("gate", amp.gate)
    g.connect("frequency", bank.frequency)
    g.connect("gate", bank.gate)
    g.connect(amp.amplitudes, bank.amplitudes)
    g.connect(bank.output, "output")
    return g


def build_electric_piano(num_voices: int = 16,
                         fused: bool = True) -> Graph:
    """``fused=True`` uses the single fused voice node (one kernel launch
    across all voices per steady block); ``fused=False`` uses the two-node
    subgraph exactly as the reference structures it.  Both are
    equivalence-tested.
    """
    g = Graph(f"ElectricPiano{num_voices}")
    g.input("midi_in", "event")
    g.input("brightness", "value", default=30.0)
    g.input("velocity_scaling", "value", default=50.0)
    g.input("decay_rate", "value", default=90.0)
    g.input("harmonic_decay", "value", default=70.0)
    g.input("key_scaling", "value", default=50.0)
    g.input("release_rate", "value", default=40.0)
    g.input("vibrato_intensity", "value", default=0.3)
    g.input("vibrato_speed", "value", default=5.0)
    g.output("note_on_out", "event")
    g.output("note_off_out", "event")
    g.output("out", "stream", channels=2)

    parser = g.add("midi_parser", MidiParser())
    alloc = g.add("voice_allocator", VoiceAllocator(num_voices))
    handlers = g.add("voice_handlers", MidiVoiceHandler(),
                     count=num_voices)
    if fused:
        from ..nodes.electric_piano import ElectricPianoVoice
        voices = g.add("voices", ElectricPianoVoice(), count=num_voices)
    else:
        voices = g.add("voices", build_voice(), count=num_voices)
    trem = g.add("tremolo", Tremolo())

    g.connect("midi_in", parser.midi_in)
    g.connect(parser.note_on, "note_on_out")
    g.connect(parser.note_off, "note_off_out")
    g.connect(parser.note_on, alloc.note_on)
    g.connect(parser.note_off, alloc.note_off)
    g.connect(alloc.voices, handlers.note_on)
    g.connect(alloc.voices, handlers.note_off)
    g.connect(handlers.frequency, voices.frequency)
    g.connect(handlers.gate, voices.gate)
    for p in ("brightness", "velocity_scaling", "decay_rate",
              "harmonic_decay", "key_scaling", "release_rate"):
        g.connect(p, f"voices.{p}")
    g.connect(voices.output, trem.input)
    g.connect("vibrato_intensity", trem.depth)
    g.connect("vibrato_speed", trem.rate)
    g.connect(trem.output, "out")
    return g
