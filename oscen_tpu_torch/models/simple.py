"""Small reference example configurations.

Counterpart of ``oscen_tpu/models/simple.py``.

- :func:`build_simple_synth` — the simple_synth graph
  (reference examples/src/bin/simple_synth.rs:5-19): PolyBLEP saw → TPT
  filter.
- :func:`build_simple_echo` — the simple-echo per-channel chain
  (reference examples/simple-echo/src/lib.rs): delay → filter with
  tanh-soft-clipped feedback from the filter output, dry/wet mix.
- :func:`build_saturator` — the oversampled saturator (reference
  examples/oversampled-saturator/src/main.rs:64-80).
"""

from __future__ import annotations

from ..graph.builder import Graph, call
from ..nodes.basic import HardClip
from ..nodes.delay import Delay
from ..nodes.filters import TptFilter
from ..nodes.oscillators import PolyBlepOscillator
from ..ops import fmath


def build_simple_synth() -> Graph:
    g = Graph("SynthGraph")
    g.output("out", "stream")
    osc = g.add("osc", PolyBlepOscillator.saw(440.0, 0.6))
    filt = g.add("filter", TptFilter(4000.0, 0.707))
    g.connect(osc.output, filt.input)
    g.connect(filt.output, "out")
    return g


def build_simple_echo(delay_seconds: float = 0.25,
                      sample_rate: float = 48_000.0,
                      min_delay: bool = True) -> Graph:
    g = Graph("SimpleEcho")
    x = g.input("x", "stream")
    fb = g.input("feedback", "value", default=0.5)
    g.input("filter_cutoff", "value", default=4000.0)
    mix = g.input("mix", "value", default=0.5)
    g.output("out", "stream")
    n = int(delay_seconds * sample_rate)
    # the static min-delay promise lets the block compiler dissolve the
    # feedback island (read -> filter chain -> write, fully vectorized);
    # without it the island runs as a per-sample scan island
    d = g.add("delay", Delay(n, 0.0, min_delay=n if min_delay else 0))
    f = g.add("filter", TptFilter(4000.0, 0.7))
    # delay input = tanh(x + filter.output * feedback): the feedback leg
    # reads the filter's previous sample (cycle broken at the Delay); the
    # tanh is float64 rounded once, the same on the CPU and the card
    g.connect(call(fmath.tanh, x + f.output * fb), d.input, feedback=True)
    g.connect(d.output, f.input)
    g.connect("filter_cutoff", f.cutoff)
    g.connect(x * (1.0 - mix) + f.output * mix, "out")
    return g


def build_saturator(factor: int = 4) -> Graph:
    """The oversampled-saturator graph: a saw at 2 kHz into a hard clip
    inside a ``rate=factor`` oversampled region, sinc downsampled at the
    boundary."""
    g = Graph(f"Sat{factor}x")
    g.output("audio_out", "stream")
    osc = g.add("osc", PolyBlepOscillator.saw(2000.0, 0.6), rate=factor)
    clip = g.add("clip", HardClip(), rate=factor)
    g.connect(osc.output, clip.input)
    g.connect(clip.output, "audio_out", policy="sinc")
    return g
