"""Differential fuzzing in oscen_tpu_torch: random graphs, sample mode
against block mode (the counterpart of ``tests/test_fuzz_graphs.py:81-104``,
the same eight seeds and the same relative RMS bound, 2e-3), and the same
graphs' sample mode against the JAX package's.

The two modes share only the IR: the per-sample schedule on one side, the
time-vectorized nodes, scan islands and dissolved delays on the other.
The random graphs mix oscillators, filters, gains, clips, delays (with
internal feedback, no promise) and gated envelopes, driven by seeded noise
and one gate event.
"""

import numpy as np
import pytest

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.graph import ir as jir
from oscen_tpu_torch.graph import ir as tir

B = 192


def _random_graph(pkg, rng, n_nodes: int):
    """tests/test_fuzz_graphs.py's generator over either package's nodes
    (the same draws from ``rng``, so both packages build the same graph)."""
    ir = jir if pkg is J else tir
    g = pkg.Graph(f"Fuzz{n_nodes}")
    g.input("gate", "event")
    g.input("x", "stream")
    g.output("out", "stream")
    makers = [
        lambda: ("osc", pkg.Oscillator(
            float(rng.uniform(50, 2000)), float(rng.uniform(0.1, 1.0)),
            rng.choice(["sine", "square", "saw"]))),
        lambda: ("posc", pkg.PolyBlepOscillator(
            float(rng.uniform(50, 2000)), float(rng.uniform(0.1, 1.0)),
            rng.choice(pkg.PolyBlepOscillator.WAVEFORMS))),
        lambda: ("tpt", pkg.TptFilter(float(rng.uniform(200, 8000)),
                                      float(rng.uniform(0.3, 3.0)))),
        lambda: ("gain", pkg.Gain(float(rng.uniform(0.2, 1.5)))),
        lambda: ("mix", pkg.Mixer()),
        lambda: ("clip", pkg.HardClip()),
        lambda: ("addv", pkg.AddValue(float(rng.uniform(-0.5, 0.5)))),
        lambda: ("xf", pkg.Crossfade()),
        lambda: ("delay", pkg.Delay(float(rng.uniform(4, 200)),
                                    float(rng.uniform(0.0, 0.8)))),
        lambda: ("env", pkg.AdsrEnvelope(
            float(rng.uniform(0.0, 0.01)), float(rng.uniform(0.001, 0.05)),
            float(rng.uniform(0.2, 1.0)), float(rng.uniform(0.001, 0.05)))),
    ]
    sources = [ir.EndpointRef("", "x")]
    for i in range(n_nodes):
        kind, node = makers[rng.integers(len(makers))]()
        name = f"{kind}{i}"
        g.add(name, node)
        for ep in node.INPUTS:
            if ep.kind.value == "stream" and rng.random() < 0.85:
                src = sources[rng.integers(len(sources))]
                if rng.random() < 0.2:
                    g.connect(src * float(rng.uniform(0.3, 1.0)),
                              ir.EndpointRef(name, ep.name))
                else:
                    g.connect(src, ir.EndpointRef(name, ep.name))
        if node.event_inputs and rng.random() < 0.8:
            g.connect("gate", ir.EndpointRef(name,
                                             node.event_inputs[0].name))
        for out in node.OUTPUTS:
            if out.kind.value == "stream" and out.channels == 1 \
                    and not out.shape:
                sources.append(ir.EndpointRef(name, out.name))
    picks = [sources[rng.integers(len(sources))] for _ in range(3)]
    expr = picks[0]
    for p in picks[1:]:
        expr = expr + p * 0.5
    g.connect(expr, "out")
    return g


def _run(pkg, seed, mode):
    rng = np.random.default_rng(seed)
    g = _random_graph(pkg, rng, int(rng.integers(3, 9)))
    kw = {"device": "cpu"} if pkg is T else {}
    c = g.compile(48000.0, block_size=B, mode=mode, **kw)
    c.queue_event("gate", 17, 0.9)
    x = np.random.default_rng(99).standard_normal(3 * B).astype(
        np.float32) * 0.3
    out = [c.process_block(stream_inputs={"x": x[i * B:(i + 1) * B]})["out"]
           for i in range(3)]
    return np.concatenate([np.asarray(o.cpu() if pkg is T else o)
                           for o in out])


@pytest.mark.parametrize("seed", range(8))
def test_random_graphs_modes_agree(seed):
    a = _run(T, seed, "sample")
    b = _run(T, seed, "block")
    assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
    scale = max(np.abs(a).max(), 1e-3)
    rms = np.sqrt(np.mean((a - b) ** 2)) / scale
    assert rms < 2e-3, (seed, rms, np.abs(a - b).max())


@pytest.mark.parametrize("seed", [0, 3, 6])
def test_random_graphs_sample_mode_matches_jax(seed):
    """The port's sample mode against the JAX package's on the same random
    graph: relative RMS 1e-4 (the README-synth class bound, 1e-5 absolute,
    over graphs whose naive oscillators round their ``sin`` once from
    float64 in the port)."""
    a = _run(J, seed, "sample")
    b = _run(T, seed, "sample")
    scale = max(np.abs(a).max(), 1e-3)
    assert np.sqrt(np.mean((a - b) ** 2)) / scale < 1e-4
