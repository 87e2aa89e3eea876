"""oscen_tpu_torch — the oscen_tpu audio-graph framework on PyTorch and CUDA.

A port of the JAX package ``oscen_tpu`` (which stays the reference) to
PyTorch, with its TPU kernels rewritten as CUDA kernels for Hopper.  Module
paths and names mirror the JAX package.  The port so far holds the
electric-piano, poly-synth, FM, twin-peaks and echo/saturator slices and
the asset slice: the graph front end, block-mode compilation on one device (``Graph.compile(...)``
runs on the CUDA card; ``device="cpu"`` asks for the CPU) with multirate
regions, feedback edges and dissolved delay islands, the host MIDI and
voice-allocation nodes, the additive voice, the tremolo, the oscillators,
the TPT, IIR and LP18 filters, the ADSR envelope and bank, the FM operator,
the delay line, the resamplers, the small utility nodes, the textual
``graph!`` DSL (``parse_graph``), audio assets with the convolver, the
sample player and the oscilloscope, and the host utilities of
``oscen_tpu_torch.utils`` (the native host library, checkpoints, bundles,
``nih_params``, the streaming host and the profiler helpers), and voice
sharding over ``torch.distributed`` (``oscen_tpu_torch.parallel``).
Tensors on the CPU run each kernel's plain PyTorch version; tensors on a
CUDA card run the kernel.
"""

from .core.events import (EventBuffer, EventInstance, EventQueue,
                          NoteOffEvent, NoteOnEvent, RawMidiMessage,
                          scalar_event)
from .core.ramp import ValueRampState
from .core.types import (DEFAULT_MAX_BLOCK_SIZE, Kind, ParamSpec, Policy,
                         SampleRate)
from .graph.builder import Frame, Graph, GraphError, call
from .graph.dsl import parse_graph, parse_oversample_variants
from .graph.node import HostNode, Node, StepValue
from .nodes.basic import (AddValue, AudioInput, Crossfade, FmOperator, Gain,
                          HardClip, Mixer, MulAdd, Tremolo, Value, Vca)
from .assets import AssetError, AudioAsset
from .nodes.convolver import Convolver
from .nodes.delay import Delay
from .nodes.electric_piano import (AmplitudeSource, ElectricPianoVoice,
                                   OscillatorBank)
from .nodes.envelope import AdsrBank, AdsrEnvelope
from .nodes.filters import DualLP18Diff, IirLowpass, LP18Filter, TptFilter
from .nodes.midi import (EventPassthrough, MidiParser, MidiVoiceHandler,
                         midi_note_to_freq, raw_midi_event)
from .nodes.oscillators import Oscillator, PolyBlepOscillator
from .nodes.oscilloscope import Oscilloscope
from .nodes.sample_player import SamplePlayer
from .nodes.voice_allocator import VoiceAllocator
from .utils.params import FloatParam, NihParams, nih_params

__version__ = "0.1.0"

__all__ = [
    "AddValue", "AdsrBank", "AdsrEnvelope", "AmplitudeSource", "AssetError",
    "AudioAsset", "AudioInput", "Convolver", "Crossfade",
    "DEFAULT_MAX_BLOCK_SIZE", "Delay", "DualLP18Diff", "ElectricPianoVoice",
    "EventBuffer", "EventInstance", "EventPassthrough", "EventQueue",
    "FloatParam", "FmOperator", "Frame", "Gain", "Graph", "GraphError",
    "HardClip", "HostNode", "IirLowpass", "Kind", "LP18Filter",
    "MidiParser", "MidiVoiceHandler", "Mixer", "MulAdd", "NihParams",
    "Node", "NoteOffEvent", "NoteOnEvent", "Oscillator", "OscillatorBank",
    "Oscilloscope", "ParamSpec", "Policy", "PolyBlepOscillator",
    "RawMidiMessage", "SampleRate", "SamplePlayer", "StepValue", "Tremolo",
    "TptFilter", "Value", "ValueRampState", "Vca", "VoiceAllocator", "call",
    "midi_note_to_freq", "nih_params", "parse_graph",
    "parse_oversample_variants", "raw_midi_event", "scalar_event",
]
