"""Twin Peaks filter — difference of two resonant 3-pole lowpasses.

Counterpart of ``oscen_tpu/models/twin_peaks.py``, a rebuild of the
reference's nih-twin-peaks plugin graph
(examples/nih-twin-peaks/src/lib.rs:15-48): one audio input feeds two LP18
(Hordijk-style) filters at different cutoffs; the output is their
difference (a movable band of resonant peaks).  Param specs mirror the
plugin's skewed ranges (``Graph.param_specs``).
"""

from __future__ import annotations

from ..core.types import ParamSpec
from ..graph.builder import Graph
from ..nodes.filters import DualLP18Diff, LP18Filter

OUTPUT_GAIN = 5.0  # applied by the host outside the graph (lib.rs:12)


def build_twin_peaks(fused: bool = True) -> Graph:
    """The nih-twin-peaks plugin graph.

    ``fused=True`` (the default) computes both LP18s in adjacent lanes of
    ONE ``lp18_scan`` launch per block (:class:`DualLP18Diff`);
    ``fused=False`` keeps the reference's two-node structure, one launch
    per filter.  The two builds are bit-identical on the CPU and on the
    card.
    """
    g = Graph("TwinPeaksGraph")
    g.input("audio_in", "stream")
    g.input("cutoff_a", "value", default=1000.0,
            spec=ParamSpec(min=20.0, max=14500.0, log=True, unit="Hz"))
    g.input("cutoff_b", "value", default=1900.0,
            spec=ParamSpec(min=20.0, max=14500.0, log=True, unit="Hz"))
    g.input("resonance", "value", default=0.54,
            spec=ParamSpec(min=0.0, max=0.99))
    g.output("audio_out", "stream")

    if fused:
        f = g.add("filters", DualLP18Diff(1000.0, 1900.0, 0.54))
        g.connect("audio_in", f.input)
        g.connect("cutoff_a", f.cutoff_a)
        g.connect("cutoff_b", f.cutoff_b)
        g.connect("resonance", f.resonance)
        g.connect(f.output, "audio_out")
        return g

    fa = g.add("filter_a", LP18Filter(1000.0, 0.54))
    fb = g.add("filter_b", LP18Filter(1900.0, 0.54))
    g.connect("audio_in", fa.input)
    g.connect("audio_in", fb.input)
    g.connect("cutoff_a", fa.cutoff)
    g.connect("cutoff_b", fb.cutoff)
    g.connect("resonance", fa.resonance)
    g.connect("resonance", fb.resonance)
    # twin peaks: the difference of the two filters
    g.connect(fa.output - fb.output, "audio_out")
    return g
