"""oscen_tpu_torch — the oscen_tpu audio-graph framework on PyTorch and CUDA.

A port of the JAX package ``oscen_tpu`` (which stays the reference) to
PyTorch, with its TPU kernels rewritten as CUDA kernels for Hopper.  Module
paths and names mirror the JAX package.  The port so far holds the
electric-piano slice: the graph front end, block-mode compilation on one
device (``Graph.compile(..., device="cpu" | "cuda")``), the host MIDI and
voice-allocation nodes, the additive voice and the tremolo.  Tensors on the
CPU run each kernel's plain PyTorch version; tensors on a CUDA card run the
kernel.
"""

from .core.events import (EventBuffer, EventInstance, NoteOffEvent,
                          NoteOnEvent, RawMidiMessage, scalar_event)
from .core.ramp import ValueRampState
from .core.types import (DEFAULT_MAX_BLOCK_SIZE, Kind, ParamSpec, Policy,
                         SampleRate)
from .graph.builder import Frame, Graph, GraphError, call
from .graph.node import HostNode, Node, StepValue
from .nodes.basic import Tremolo
from .nodes.electric_piano import (AmplitudeSource, ElectricPianoVoice,
                                   OscillatorBank)
from .nodes.midi import (MidiParser, MidiVoiceHandler, midi_note_to_freq,
                         raw_midi_event)
from .nodes.voice_allocator import VoiceAllocator

__version__ = "0.1.0"

__all__ = [
    "AmplitudeSource", "DEFAULT_MAX_BLOCK_SIZE", "ElectricPianoVoice",
    "EventBuffer", "EventInstance", "Frame", "Graph", "GraphError",
    "HostNode", "Kind", "MidiParser", "MidiVoiceHandler", "Node",
    "NoteOffEvent", "NoteOnEvent", "OscillatorBank", "ParamSpec", "Policy",
    "RawMidiMessage", "SampleRate", "StepValue", "Tremolo",
    "ValueRampState", "VoiceAllocator", "call", "midi_note_to_freq",
    "raw_midi_event", "scalar_event",
]
