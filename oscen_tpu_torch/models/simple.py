"""Small reference example configurations.

Counterpart of ``oscen_tpu/models/simple.py``.

- :func:`build_simple_synth` — the simple_synth graph
  (reference examples/src/bin/simple_synth.rs:5-19): PolyBLEP saw → TPT
  filter.
- :func:`build_simple_echo` and :func:`build_saturator` need ``Delay``,
  feedback edges and oversampled regions, which come with Slice E
  (ROADMAP.md queue 1); they raise ``NotImplementedError``.
"""

from __future__ import annotations

from ..graph.builder import Graph
from ..nodes.filters import TptFilter
from ..nodes.oscillators import PolyBlepOscillator


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
    raise NotImplementedError(
        "build_simple_echo needs Delay and feedback edges, which are not "
        "ported yet (ROADMAP.md queue 1, Slice E)")


def build_saturator(factor: int = 4) -> Graph:
    raise NotImplementedError(
        "build_saturator needs oversampled regions and HardClip, which are "
        "not ported yet (ROADMAP.md queue 1, Slice E)")
