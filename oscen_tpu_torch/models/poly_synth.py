"""Polyphonic subtractive synth — the JAX package's interim flagship.

Counterpart of ``oscen_tpu/models/poly_synth.py``: a voices-batched
version of the reference's README synth + MIDI stack: MidiParser →
VoiceAllocator → per-voice MidiVoiceHandler → (PolyBlep saw → TptFilter) *
AdsrEnvelope → fan-in mix.  The voice axis is the instance axis of one
``phase_scan`` and one ``tpt_svf_scan`` launch per block; the mix-down is
the FanIn sum (reference emit_edge.rs:67-84).
"""

from __future__ import annotations

from ..graph.builder import Graph
from ..nodes.envelope import AdsrEnvelope
from ..nodes.filters import TptFilter
from ..nodes.midi import MidiParser, MidiVoiceHandler
from ..nodes.oscillators import PolyBlepOscillator
from ..nodes.voice_allocator import VoiceAllocator


def build_poly_synth(num_voices: int = 16) -> Graph:
    g = Graph(f"PolySynth{num_voices}")
    g.input("midi_in", "event")
    cutoff = g.input("cutoff", "value", default=2500.0)
    res = g.input("resonance", "value", default=0.707)
    g.output("audio_out", "stream")

    parser = g.add("parser", MidiParser())
    alloc = g.add("alloc", VoiceAllocator(num_voices))
    handlers = g.add("handlers", MidiVoiceHandler(), count=num_voices)
    envs = g.add("envs", AdsrEnvelope(0.005, 0.08, 0.7, 0.2),
                 count=num_voices)
    oscs = g.add("oscs", PolyBlepOscillator.saw(440.0, 0.5),
                 count=num_voices)
    filts = g.add("filts", TptFilter(2500.0, 0.707), count=num_voices)

    g.connect("midi_in", parser.midi_in)
    g.connect(parser.note_on, alloc.note_on)
    g.connect(parser.note_off, alloc.note_off)
    g.connect(alloc.voices, handlers.note_on)
    g.connect(alloc.voices, handlers.note_off)
    g.connect(handlers.gate, envs.gate)
    g.connect(handlers.frequency, oscs.frequency)
    g.connect(oscs.output, filts.input)
    g.connect(cutoff, filts.cutoff)
    g.connect(res, filts.q)
    # per-voice VCA then fan-in mix-down (scaled to keep headroom)
    g.connect(filts.output * envs.output * (1.0 / max(num_voices, 1)),
              "audio_out")
    return g
