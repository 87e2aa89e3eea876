"""Sample mode in oscen_tpu_torch against the JAX package's sample mode on
the CPU: the models through ``compile(..., mode="sample")`` in both
packages, a JAX sample-mode state carried into the port, the default mode,
and the graphs sample mode refuses.

Inputs are seeded numpy noise and the models' own event sequences.  The
tolerances are the ones the port already holds each model to against the
JAX package in block mode (``tests/torch_jax_distance.py`` prints the
filter, echo and saturator distances they rest on):

- 1e-5 absolute for the README synth, the poly synth and the fm synth and
  pivot (their transcendentals round once from float64 in the port, XLA's
  float32 ones in JAX; ``test_torch_poly_synth.py``,
  ``test_torch_fm_synth.py``); the pivot with ``op3_feedback`` 0.3 at RMS
  1e-4 (``test_torch_fm_synth.py::test_model_matches_jax``);
- 1e-4 absolute for the piano (``test_torch_electric_piano.py``: the
  rotation multipliers' ``sin`` / ``cos``);
- 1e-6 absolute for the twin peaks, the echo, the saturators and the
  ``via=24`` feedback island (XLA's FMA contraction and float32 ``tanh``,
  ``test_torch_twin_peaks.py``, ``test_torch_echo_saturator.py``).
"""

import jax
import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.models import electric_piano as jep
from oscen_tpu.models import fm_synth as jfm
from oscen_tpu.models import pivot as jpv
from oscen_tpu.models import poly_synth as jpoly
from oscen_tpu.models import simple as jsimple
from oscen_tpu.models import twin_peaks as jtp
from oscen_tpu_torch.graph.compile import CompiledGraph
from oscen_tpu_torch.models import electric_piano as tep
from oscen_tpu_torch.models import fm_synth as tfm
from oscen_tpu_torch.models import pivot as tpv
from oscen_tpu_torch.models import poly_synth as tpoly
from oscen_tpu_torch.models import simple as tsimple
from oscen_tpu_torch.models import twin_peaks as ttp
from oscen_tpu_torch.ops.cuda import iir as tiir
from oscen_tpu_torch.utils.convert import state_from_jax

SR = 48000.0
X = (np.random.default_rng(3).standard_normal(2048) * 0.3).astype(np.float32)


def _sample(pkg, g, B):
    """``g`` compiled in sample mode (the port on the CPU)."""
    kw = {"device": "cpu"} if pkg is T else {}
    return g.compile(SR, block_size=B, mode="sample", **kw)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _blocks(c, n, out, before=None, stream=None):
    """``n`` blocks of output ``out``; ``before(i, c)`` runs before block
    ``i``; ``stream`` feeds the graph's stream input block by block."""
    ys = []
    for i in range(n):
        if before is not None:
            before(i, c)
        si = None
        if stream is not None:
            B = c.block_size
            name = next(gi.name for gi in c.ir.inputs
                        if gi.kind.value == "stream")
            si = {name: stream[i * B:(i + 1) * B]}
        ys.append(_np(c.process_block(stream_inputs=si)[out]))
    return np.concatenate(ys)


def _readme(pkg):
    g = pkg.Graph("Synth")
    for name, v in (("mod_freq", 5.0), ("mod_depth", 0.2),
                    ("carrier_freq", 440.0), ("cutoff", 1200.0)):
        g.input(name, "value", default=v)
    g.output("audio_out", "stream")
    modulator = g.add("modulator", pkg.PolyBlepOscillator.sine(5.0, 0.2))
    carrier = g.add("carrier", pkg.PolyBlepOscillator.saw(440.0, 0.5))
    filt = g.add("filter", pkg.TptFilter(1200.0, 0.707))
    g.connect("mod_freq", modulator.frequency)
    g.connect("mod_depth", modulator.amplitude)
    g.connect("carrier_freq", carrier.frequency)
    g.connect("cutoff", filt.cutoff)
    g.connect(modulator.output, carrier.frequency_mod)
    g.connect(carrier.output, filt.input)
    g.connect(filt.output, "audio_out")
    return g


def _via_island(pkg):
    """tests/test_block_mode.py's feedback island: gain -> [24] -> gain."""
    g = pkg.Graph("FB")
    g.input("x", "stream")
    g.output("out", "stream")
    mix = g.add("mix", pkg.Gain(1.0))
    fb = g.add("fb", pkg.Gain(0.6))
    g.connect("x", mix.input)
    g.connect(mix.output, fb.input)
    g.connect(fb.output, mix.input, via=24)
    g.connect(mix.output, "out")
    return g


def _sat_iir(pkg, factor=4):
    g = pkg.Graph(f"Sat{factor}iir")
    g.output("audio_out", "stream")
    osc = g.add("osc", pkg.PolyBlepOscillator.saw(2000.0, 0.6), rate=factor)
    clip = g.add("clip", pkg.HardClip(), rate=factor)
    g.connect(osc.output, clip.input)
    g.connect(clip.output, "audio_out", policy="sinc_iir")
    return g


def _poly_events(pkg):
    def before(i, c):
        if i == 0:
            for note in (60, 64, 67):
                c.queue_event("midi_in", 10,
                              pkg.raw_midi_event([0x90, note, 100]))
        if i == 1:
            c.queue_event("midi_in", 0, pkg.raw_midi_event([0x80, 64, 0]))
        if i == 3:
            c.set_value_with_ramp("cutoff", 800.0, 100)
    return before


def _fm_events(pkg, feedback_at=None):
    def before(i, c):
        if i == 0:
            c.set_value("route", 0.4)
            for note in (48, 60, 67):
                c.queue_event("midi_in", 7,
                              pkg.raw_midi_event([0x90, note, 100]))
        if i == 1:
            c.queue_event("midi_in", 26, pkg.raw_midi_event([0x90, 72, 90]))
        if i == feedback_at:
            c.set_value("op3_feedback", 0.3)
    return before


def _piano_events(pkg):
    def before(i, c):
        if i == 0:
            for n, off in ((60, 0), (64, 10), (67, 30)):
                c.queue_event("midi_in", off,
                              pkg.raw_midi_event([0x90, n, 100]))
        if i == 3:
            c.queue_event("midi_in", 5, pkg.raw_midi_event([0x80, 60, 0]))
    return before


def _twin_events(i, c):
    if i == 2:
        c.set_value("cutoff_a", 640.0)
        c.set_value("resonance", 0.8)


# (id, build(pkg), B, blocks, output, before(pkg) or None, stream, atol)
MODELS = [
    ("readme_synth", _readme, 256, 4, "audio_out", None, None, 1e-5),
    ("poly_synth", lambda p: (jpoly if p is J else tpoly).build_poly_synth(4),
     64, 6, "audio_out", _poly_events, None, 1e-5),
    ("fm_synth", lambda p: (jfm if p is J else tfm).build_fm_synth(4),
     64, 4, "audio_out", _fm_events, None, 1e-5),
    ("piano", lambda p: (jep if p is J else tep).build_electric_piano(2),
     64, 5, "out", _piano_events, None, 1e-4),
    ("twin_peaks", lambda p: (jtp if p is J else ttp).build_twin_peaks(),
     256, 4, "audio_out", lambda p: _twin_events, X, 1e-6),
    ("echo_promise", lambda p: (jsimple if p is J else tsimple)
     .build_simple_echo(0.02, SR), 256, 6, "out",
     lambda p: lambda i, c: c.set_value("feedback", 0.6) if i == 0 else None,
     X, 1e-6),
    ("echo_no_promise", lambda p: (jsimple if p is J else tsimple)
     .build_simple_echo(0.02, SR, min_delay=False), 256, 6, "out",
     lambda p: lambda i, c: c.set_value("feedback", 0.6) if i == 0 else None,
     X, 1e-6),
    ("saturator_sinc", lambda p: (jsimple if p is J else tsimple)
     .build_saturator(4), 256, 4, "audio_out", None, None, 1e-6),
    ("saturator_sinc_iir", _sat_iir, 256, 4, "audio_out", None, None, 1e-6),
    ("via24_island", _via_island, 128, 4, "out", None, X, 1e-6),
]


@pytest.mark.parametrize("case", MODELS, ids=[m[0] for m in MODELS])
def test_sample_mode_matches_jax(case):
    _, build, B, n, out, events, stream, atol = case
    a = _blocks(_sample(J, build(J), B), n, out,
                events(J) if events else None, stream)
    b = _blocks(_sample(T, build(T), B), n, out,
                events(T) if events else None, stream)
    assert b.shape == a.shape
    assert np.abs(a).max() > 0.01
    np.testing.assert_allclose(b, a, atol=atol, rtol=0)


def test_pivot_with_feedback_matches_jax():
    """The pivot, op3_feedback 0.3 from block 2: max abs 1e-5 before it,
    RMS 1e-4 after (the bound the JAX package holds between its two pivot
    builds, tests/test_pivot.py:129-148)."""
    def run(pkg):
        g = (jpv if pkg is J else tpv).build_pivot(4)
        return _blocks(_sample(pkg, g, 64), 5, "audio_out",
                       _fm_events(pkg, feedback_at=2))
    a, b = run(J), run(T)
    np.testing.assert_allclose(b[:128], a[:128], atol=1e-5, rtol=0)
    assert np.sqrt(np.mean((b[128:] - a[128:]) ** 2)) <= 1e-4
    assert np.abs(a[128:]).max() > 0.01


def test_state_carried_from_jax_sample_mode():
    """One block of the poly synth in JAX's sample mode, its state (numpy)
    into the port's sample mode, and the next blocks agree at 1e-5."""
    jc = _sample(J, jpoly.build_poly_synth(4), 64)
    tc = _sample(T, tpoly.build_poly_synth(4), 64)
    for c, pkg in ((jc, J), (tc, T)):
        for note in (48, 55, 62):
            c.queue_event("midi_in", 5, pkg.raw_midi_event([0x90, note, 90]))
        c.process_block()
    tc.state = state_from_jax(jax.tree_util.tree_map(np.asarray, jc.state),
                              device="cpu")
    a = _blocks(jc, 3, "audio_out")
    b = _blocks(tc, 3, "audio_out")
    assert np.abs(a).max() > 0.01
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


def test_compiled_graph_defaults_to_sample_mode():
    """``CompiledGraph`` takes the JAX package's default, ``mode="sample"``;
    ``Graph.compile`` keeps ``"block"`` in both packages."""
    import inspect
    from oscen_tpu.graph.compile import CompiledGraph as JCompiled
    g = tsimple.build_saturator(2)
    assert CompiledGraph(g.lower(), SR, 64, device="cpu").mode == "sample"
    assert g.compile(SR, block_size=64, device="cpu").mode == "block"
    for cls in (JCompiled, CompiledGraph):
        assert inspect.signature(cls).parameters["mode"].default == "sample"
    for graph_cls in (J.Graph, T.Graph):
        assert inspect.signature(graph_cls.compile).parameters[
            "mode"].default == "block"
    with pytest.raises(ValueError, match="unknown mode"):
        CompiledGraph(g.lower(), SR, 64, mode="frame", device="cpu")


def test_sample_mode_k10_launches_per_outer_sample(monkeypatch):
    """The IIR-halfband boundary in sample mode runs its down resampler
    once per outer sample: one ``allpass_cascade_scan`` per halfband stage
    (2 at 4x), each over that stage's 2 or 1 samples.  Counted here on the
    wrapper's plain version (the card counts the kernel's launches)."""
    calls = []
    real = tiir.plain_allpass_cascade_scan

    def counting(x, *a):
        calls.append(x.shape[0])
        return real(x, *a)
    monkeypatch.setattr(tiir, "plain_allpass_cascade_scan", counting)
    c = _sample(T, _sat_iir(T), 32)
    calls.clear()
    c.process_block()
    assert calls == [2, 1] * 32


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
def test_sample_mode_refuses_what_the_reference_refuses(pkg):
    """Mixed inner rates and the down-then-up diamond raise ValueError in
    both packages (the reference rejects both, lower.rs:797-809,
    emit_node.rs:516-584), in either mode."""
    kw = {"device": "cpu"} if pkg is T else {}
    g = pkg.Graph("Mixed")
    g.output("out_a", "stream")
    g.output("out_b", "stream")
    a = g.add("a", pkg.PolyBlepOscillator.saw(500.0, 0.4), rate=2)
    b = g.add("b", pkg.PolyBlepOscillator.saw(700.0, 0.4), rate=4)
    g.connect(a.output, "out_a", policy="sinc")
    g.connect(b.output, "out_b", policy="sinc")
    with pytest.raises(ValueError, match="mixed oversampling"):
        g.compile(SR, block_size=64, mode="sample", **kw)

    d = pkg.Graph("Diamond")
    d.output("out", "stream")
    up = d.add("up", pkg.HardClip(), rate=2)
    mid = d.add("mid", pkg.HardClip())
    up2 = d.add("up2", pkg.HardClip(), rate=2)
    osc = d.add("osc", pkg.PolyBlepOscillator.saw(500.0, 0.4))
    d.connect(osc.output, up.input, policy="sinc")
    d.connect(up.output, mid.input, policy="sinc")
    d.connect(mid.output, up2.input, policy="sinc")
    d.connect(up2.output, "out", policy="sinc")
    for mode in ("sample", "block"):
        with pytest.raises(ValueError, match="diamond"):
            d.compile(SR, block_size=64, mode=mode, **kw)
