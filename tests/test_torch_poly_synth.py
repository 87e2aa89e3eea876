"""The poly-synth slice end to end on the CPU: oscen_tpu_torch against the
JAX package, and the port's own invariants.

- Nodes (``PolyBlepOscillator`` in its four waveforms, ``Oscillator``,
  ``TptFilter``, ``AdsrEnvelope``) in small graphs, against JAX's
  ``CompiledGraph`` output: node arrays take the port's batched path (the
  plain versions of ``phase_scan`` / ``tpt_svf_scan`` on the CPU), single
  nodes its block path.
- ``build_poly_synth(8)`` against JAX's composed path and against JAX with
  ``OSCEN_PALLAS_INTERPRET=1`` (its phase and TPT Pallas kernels in
  interpret mode), and ``build_simple_synth()``.
- State carried from the JAX package into the port mid-run.
- Block-size invariance inside the port, bit for bit.
- The block compiler hands ``const_ins`` to batched methods that take it.
"""

import jax
import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.models.poly_synth import build_poly_synth as jpoly
from oscen_tpu.models.simple import build_simple_synth as jsimple
from oscen_tpu_torch.core.types import stream, value
from oscen_tpu_torch.models import simple as tsimple_mod
from oscen_tpu_torch.models.poly_synth import build_poly_synth as tpoly
from oscen_tpu_torch.models.simple import build_simple_synth as tsimple
from oscen_tpu_torch.ops.cuda import iir as tiir
from oscen_tpu_torch.ops.cuda import phase as tphase
from oscen_tpu_torch.utils.convert import state_from_jax, state_to_numpy

SR = 48000.0
ATOL = 1e-5


def _cpu(pkg):
    """The port's graphs compile for the card unless asked for the CPU; the
    JAX package's ``compile`` takes no device."""
    return {"device": "cpu"} if pkg is T else {}


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _run(c, blocks, out="out", stream=None):
    """Render ``blocks``: a list of callables applied to the compiled graph
    before each block (setters, events), one block each; ``stream`` maps
    stream inputs to their samples."""
    outs, B = [], c.block_size
    for i, setup in enumerate(blocks):
        setup(c)
        si = None if stream is None else {
            k: v[i * B:(i + 1) * B] for k, v in stream.items()}
        outs.append(_np(c.process_block(stream_inputs=si)[out]))
    return np.concatenate(outs)


def _nothing(c):
    pass


# ------------------------------------------------------------------ #
# oscillators
# ------------------------------------------------------------------ #
OSCS = {
    "blep_saw": lambda pkg: pkg.PolyBlepOscillator.saw(330.0, 0.5),
    "blep_square": lambda pkg: pkg.PolyBlepOscillator(330.0, 0.5, "square"),
    "blep_triangle": lambda pkg: pkg.PolyBlepOscillator.triangle(330.0, 0.5),
    "blep_sine": lambda pkg: pkg.PolyBlepOscillator.sine(330.0, 0.5),
    "naive_saw": lambda pkg: pkg.Oscillator.saw(330.0, 0.7),
    "naive_square": lambda pkg: pkg.Oscillator.square(330.0, 0.7),
    "naive_sine": lambda pkg: pkg.Oscillator.sine(330.0, 0.7),
}


def _osc_graph(pkg, make, count):
    """An oscillator (array) whose frequency is a graph input and whose
    frequency_mod is a stream input (a slow vibrato, fed the same samples
    in both packages)."""
    g = pkg.Graph("O")
    g.input("freq", "value", default=330.0)
    g.input("fm", "stream")
    g.output("out", "stream")
    o = g.add("o", make(pkg), count=count)
    g.connect("freq", o.frequency)
    g.connect("fm", o.frequency_mod)
    g.connect(o.output, "out")
    return g


_VIBRATO = (0.3 * np.sin(np.arange(8 * 64) / 30.0)).astype(np.float32)


@pytest.mark.parametrize("count", [1, 3])
@pytest.mark.parametrize("name", sorted(OSCS))
def test_oscillator_matches_jax(name, count):
    """Steady blocks, a frequency ramp past sr/4 (the polyBLEP shapes fall
    back to sine there) and back: atol 1e-5 (the port's sin rounds once
    from float64, XLA's float32 sin may differ by an ulp)."""
    blocks = [_nothing] * 3 + [
        lambda c: c.set_value_with_ramp("freq", 13000.0, 100),
        _nothing, lambda c: c.set_value_with_ramp("freq", 220.0, 30),
        _nothing, _nothing]
    fm = {"fm": _VIBRATO}
    a = _run(_osc_graph(J, OSCS[name], count).compile(SR, block_size=64),
             blocks, stream=fm)
    b = _run(_osc_graph(T, OSCS[name], count).compile(SR, block_size=64,
                                                      device="cpu"),
             blocks, stream=fm)
    assert b.shape == a.shape == (8 * 64,)
    assert np.abs(a).max() > 0.3
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)


def test_oscillator_array_runs_one_batched_scan():
    c = _osc_graph(T, OSCS["blep_saw"], 3).compile(SR, block_size=64,
                                                   device="cpu")
    rep = c.explain()
    assert {"node": "o", "kernel": "phase_scan"} in rep
    assert {"node": "o", "path": "batched"} in rep


# ------------------------------------------------------------------ #
# TPT filter
# ------------------------------------------------------------------ #
def _filter_graph(pkg, count, channels, fmod):
    g = pkg.Graph("F")
    g.input("x", "stream", channels=channels)
    g.input("cutoff", "value", default=1200.0)
    if fmod:
        g.input("fm", "stream")
    g.output("out", "stream", channels=channels)
    f = g.add("f", pkg.TptFilter(1200.0, 2.0, channels=channels),
              count=count)
    g.connect("x", f.input)
    g.connect("cutoff", f.cutoff)
    if fmod:
        g.connect("fm", f.f_mod)
    g.connect(f.output, "out")
    return g


@pytest.mark.parametrize("count,channels,fmod", [
    (3, 1, True), (3, 1, False), (1, 2, False), (3, 2, False), (1, 1, True)])
def test_tpt_filter_matches_jax(count, channels, fmod):
    """A per-sample f_mod stream (the per-sample coefficient sweep on every
    block) or a cutoff ramp (sweep during the ramp, hoisted rows around
    it), mono and stereo, node arrays and single nodes: atol 1e-5."""
    B, n = 64, 8
    rng = np.random.default_rng(count * 10 + channels)
    shape = (B * n,) if channels == 1 else (B * n, channels)
    x = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    fm = (0.8 * np.sin(np.arange(B * n) / 40.0)).astype(np.float32)

    def run(pkg):
        c = _filter_graph(pkg, count, channels, fmod).compile(
            SR, block_size=B, **_cpu(pkg))
        outs = []
        for i in range(n):
            if i == 2:
                c.set_value_with_ramp("cutoff", 5000.0, 100)
            si = {"x": x[i * B:(i + 1) * B]}
            if fmod:
                si["fm"] = fm[i * B:(i + 1) * B]
            outs.append(_np(c.process_block(B, stream_inputs=si)["out"]))
        return np.concatenate(outs), c
    a, _ = run(J)
    b, c = run(T)
    assert b.shape == a.shape == shape
    assert np.abs(a).max() > 0.1
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)
    if count > 1:
        path = "sweep" if fmod else "hoisted"
        assert {"node": "f", "kernel": "tpt_svf_scan",
                "coef_path": path} in c.explain()


# ------------------------------------------------------------------ #
# ADSR envelope
# ------------------------------------------------------------------ #
def _env_graph(pkg, params, count):
    g = pkg.Graph("Env")
    g.input("gate", "event")
    g.output("out", "stream")
    env = g.add("env", pkg.AdsrEnvelope(*params), count=count)
    g.connect("gate", env.gate)
    g.connect(env.output, "out")
    return g


def _gates(evs):
    def setup(c):
        for off, v in evs:
            c.queue_event("gate", off, v)
    return setup


@pytest.mark.parametrize("count", [1, 2])
@pytest.mark.parametrize("params,events", [
    # attack spans blocks; gate-off mid-block; retrigger while decaying
    # (tests/test_block_mode.py:28-50)
    ((0.004, 0.03, 0.6, 0.05),
     [[(100, 1.0)], [], [(37, 0.0)], [(200, 0.8), (400, 0.0)], []]),
    # zero-attack and retrigger mid-decay, then a zero-release gate-off
    ((0.0, 0.02, 0.5, 0.0),
     [[(130, 1.0)], [(50, 0.9)], [], [(3, 0.0), (300, 0.7)], []]),
], ids=["a_d_s_r", "zero_shortcuts"])
def test_adsr_envelope_matches_jax(params, events, count):
    """Closed forms with gate events at B=512: atol 1e-5 (exp/log round
    once in float64 in the port)."""
    blocks = [_gates(e) for e in events]
    a = _run(_env_graph(J, params, count).compile(SR, block_size=512),
             blocks)
    b = _run(_env_graph(T, params, count).compile(SR, block_size=512,
                                                  device="cpu"),
             blocks)
    assert np.abs(a).max() > 0.5
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)


# ------------------------------------------------------------------ #
# the models
# ------------------------------------------------------------------ #
def _poly_sequence(pkg, c):
    """The chord and note-off of tests/test_block_mode.py:53-67 at B=64,
    then a cutoff ramp (the filter's per-sample coefficient path)."""
    def chord(c):
        for note in (60, 64, 67):
            c.queue_event("midi_in", 10, pkg.raw_midi_event([0x90, note,
                                                            100]))

    def note_off(c):
        c.queue_event("midi_in", 0, pkg.raw_midi_event([0x80, 64, 0]))
    blocks = [chord, note_off] + [_nothing] * 3 + [
        lambda c: c.set_value_with_ramp("cutoff", 800.0, 100)] \
        + [_nothing] * 2
    return _run(c, blocks, out="audio_out")


@pytest.mark.parametrize("interpret", [False, True],
                         ids=["jax_composed", "jax_pallas_interpret"])
def test_poly_synth_matches_jax(interpret, monkeypatch):
    """build_poly_synth(8) at B=64 against the JAX package's CPU path and
    against its Pallas phase and TPT kernels in interpret mode: atol
    1e-5."""
    if interpret:
        monkeypatch.setenv("OSCEN_PALLAS_INTERPRET", "1")
        monkeypatch.setenv("OSCEN_UNROLL_CAP", "1")   # compile time only
    a = _poly_sequence(J, jpoly(8).compile(SR, block_size=64))
    tphase.reset_launches()
    tiir.reset_launches()
    b = _poly_sequence(T, tpoly(8).compile(SR, block_size=64, device="cpu"))
    assert b.shape == a.shape == (8 * 64,)
    assert np.abs(a).max() > 0.02
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)
    # on the CPU the wrappers run the plain versions: no launches
    assert tphase.launches["phase_scan"] == tiir.launches["tpt_svf_scan"] == 0


def test_poly_synth_lowers_to_the_same_ir():
    ja, tb = jpoly(8).lower(), tpoly(8).lower()
    assert list(ja.order) == list(tb.order)
    assert {n: (i.count, type(i.node).__name__) for n, i in ja.nodes.items()} \
        == {n: (i.count, type(i.node).__name__) for n, i in tb.nodes.items()}
    assert [(e.dst_node, e.dst_endpoint, e.fanout.value) for e in ja.edges] \
        == [(e.dst_node, e.dst_endpoint, e.fanout.value) for e in tb.edges]


def test_simple_synth_matches_jax():
    a = jsimple().compile(SR, block_size=512).render_mono(4800)
    b = tsimple().compile(SR, block_size=512, device="cpu").render_mono(4800)
    assert b.shape == a.shape == (4800,)
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)
    # tests/test_models_aux.py:15-21: the saw's fundamental
    spec = np.abs(np.fft.rfft(b[480:] * np.hanning(4320)))
    freqs = np.fft.rfftfreq(4320, 1 / SR)
    assert abs(freqs[spec.argmax()] - 440.0) < 15.0


def test_unported_simple_models_raise():
    """The echo and the saturator came with Slice E; the echo without its
    min-delay promise, whose feedback island is a per-sample scan island,
    came with sample mode: it raises no more and matches the dissolved
    echo at 1e-6 (the JAX package's bound between the two,
    tests/test_delay_feedback.py:236)."""
    x = (np.random.default_rng(2).standard_normal(1024) * 0.3).astype(
        np.float32)
    outs = []
    for md in (False, True):
        e = tsimple_mod.build_simple_echo(0.002, SR, min_delay=md).compile(
            SR, block_size=64, device="cpu")
        e.set_value("feedback", 0.5)
        outs.append(e.render_mono(1024, stream_inputs={"x": x}))
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6, rtol=0)
    sat = tsimple_mod.build_saturator().compile(SR, block_size=64,
                                               device="cpu")
    assert sat.latency_samples() == 8


def test_state_carried_from_jax():
    """The same chord block in both packages, then the JAX state (numpy)
    into the port's CompiledGraph; four more blocks agree at 1e-5.  The
    ADSR's int32 leaves keep their dtype both ways."""
    jc = jpoly(8).compile(SR, block_size=64)
    tc = tpoly(8).compile(SR, block_size=64, device="cpu")
    for c, pkg in ((jc, J), (tc, T)):
        for note in (48, 55, 62, 69):
            c.queue_event("midi_in", 5, pkg.raw_midi_event([0x90, note, 90]))
        c.process_block()
    np_state = jax.tree_util.tree_map(np.asarray, jc.state)
    tc.state = state_from_jax(np_state, device="cpu")
    for key in ("stage", "rem", "age", "stage_len"):
        assert tc.state["envs"][key].dtype == torch.int32
        assert state_to_numpy(tc.state)["envs"][key].dtype == np.int32
    assert int(tc.state["envs"]["stage"].max()) == 1   # attacking voices
    a = np.concatenate([_np(jc.process_block()["audio_out"])
                        for _ in range(4)])
    b = np.concatenate([_np(tc.process_block()["audio_out"])
                        for _ in range(4)])
    assert np.abs(a).max() > 0.01
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)
    back = state_to_numpy(tc.state)
    jstate = jax.tree_util.tree_map(np.asarray, jc.state)
    for key in ("stage", "rem", "age", "stage_len"):
        np.testing.assert_array_equal(back["envs"][key], jstate["envs"][key])


# ------------------------------------------------------------------ #
# block-size invariance inside the port (tests/test_block_invariance.py)
# ------------------------------------------------------------------ #
def _render_chunked(build, total, sizes, events=()):
    outs = {}
    for bs in sizes:
        c = build().compile(SR, block_size=bs, device="cpu")
        chunks, pos = [], 0
        while pos < total:
            n = min(bs, total - pos)
            for (at, name, val) in events:
                if pos <= at < pos + n:
                    c.queue_event(name, at - pos, val)
            chunks.append(_np(c.process_block(n)["out"]))
            pos += n
        outs[bs] = np.concatenate(chunks)
    sizes = sorted(outs)
    for bs in sizes[1:]:
        np.testing.assert_array_equal(outs[sizes[0]], outs[bs],
                                      err_msg=f"block {bs} vs {sizes[0]}")
    return outs[sizes[0]]


def _single(make):
    def build():
        g = T.Graph("S")
        g.output("out", "stream")
        o = g.add("o", make())
        g.connect(o.output, "out")
        return g
    return build


def _tpt_voice():
    g = T.Graph("T")
    g.output("out", "stream")
    o = g.add("o", T.PolyBlepOscillator.square(220.0, 0.5))
    f = g.add("f", T.TptFilter(800.0, 2.0))
    g.connect(o.output, f.input)
    g.connect(f.output, "out")
    return g


def _env(params):
    def build():
        g = T.Graph("E")
        g.input("gate", "event")
        g.output("out", "stream")
        e = g.add("e", T.AdsrEnvelope(*params))
        g.connect("gate", e.gate)
        g.connect(e.output, "out")
        return g
    return build


def _full_voice():
    """osc * env -> filter, gated mid-block; the VCA is the expression
    edge ``o.output * e.output`` (the port has no Gain node yet)."""
    g = T.Graph("V")
    g.input("gate", "event")
    g.output("out", "stream")
    o = g.add("o", T.PolyBlepOscillator.saw(220.0, 0.5))
    e = g.add("e", T.AdsrEnvelope(0.01, 0.1, 0.6, 0.05))
    f = g.add("f", T.TptFilter(1500.0, 0.9))
    g.connect("gate", e.gate)
    g.connect(o.output * e.output, f.input)
    g.connect(f.output, "out")
    return g


@pytest.mark.parametrize("case", [
    "saw", "naive", "tpt", "adsr_events", "adsr_zero", "full_voice"])
def test_block_size_invariance(case):
    """Bit-identical output whatever the block size, partial blocks
    included (sizes and events of tests/test_block_invariance.py)."""
    if case == "saw":
        _render_chunked(_single(lambda: T.PolyBlepOscillator.saw(440.0, 0.5)),
                        2048, (512, 128, 64, 96))
    elif case == "naive":
        _render_chunked(_single(lambda: T.Oscillator.saw(220.0, 0.7)),
                        2048, (512, 100, 37))
    elif case == "tpt":
        _render_chunked(_tpt_voice, 2048, (512, 128, 64))
    elif case == "adsr_events":
        out = _render_chunked(
            _env((0.005, 0.05, 0.5, 0.02)), 4096, (512, 128, 160, 1024),
            [(700, "gate", 1.0), (1500, "gate", 0.8), (2900, "gate", 0.0)])
        assert np.abs(out).max() > 0.1
    elif case == "adsr_zero":
        _render_chunked(_env((0.0, 0.0, 0.8, 0.01)), 2048, (512, 64),
                        [(130, "gate", 1.0), (1000, "gate", 0.0)])
    else:
        out = _render_chunked(_full_voice, 4096, (512, 128, 250),
                              [(333, "gate", 1.0), (3000, "gate", 0.0)])
        assert np.abs(out).max() > 0.05


# ------------------------------------------------------------------ #
# block compiler: batched methods get the keyword arguments they take
# ------------------------------------------------------------------ #
class _ConstProbe(T.Node):
    """A node array whose batched method takes only ``const_ins``."""

    INPUTS = (value("level", 1.0), stream("x", 0.0))
    OUTPUTS = (stream("output"),)
    BATCHED = True

    def __init__(self):
        self.seen = []

    def process_block(self, state, ins, events, sr, block_len):
        return state, {"output": ins["level"] * ins["x"]}

    def process_block_batched(self, state, ins, events, sr, block_len,
                              const_ins):
        self.seen.append(const_ins)
        return self.process_block(state, ins, events, sr, block_len)


def test_batched_method_receives_const_ins():
    """A staged [1] idle value is block-constant; a ramping one is not.
    The x stream input (a graph stream) never is."""
    g = T.Graph("P")
    g.input("level", "value", default=0.5)
    g.input("x", "stream")
    g.output("out", "stream")
    p = g.add("p", _ConstProbe(), count=2)
    g.connect("level", p.level)
    g.connect("x", p.x)
    g.connect(p.output, "out")
    c = g.compile(SR, block_size=32, device="cpu")
    probe = c.ir.nodes["p"].node
    x = {"x": np.ones(32, np.float32)}
    c.process_block(stream_inputs=x)
    c.set_value_with_ramp("level", 1.0, 64)
    ramp = c.process_block(stream_inputs=x)["out"]
    assert probe.seen == [frozenset({"level"}), frozenset()]
    assert float(ramp[-1]) > float(ramp[0])      # the ramp reached it


def test_tpt_filter_coefficient_path_follows_const_ins():
    """In the poly synth the filter hoists its coefficients while cutoff
    and resonance are idle, and sweeps them while the cutoff ramps."""
    c = tpoly(4).compile(SR, block_size=64, device="cpu")
    c.queue_event("midi_in", 0, T.raw_midi_event([0x90, 60, 100]))
    c.process_block()
    assert {"node": "filts", "kernel": "tpt_svf_scan",
            "coef_path": "hoisted"} in c.explain()
    c.set_value_with_ramp("cutoff", 900.0, 500)
    c.process_block()
    assert {"node": "filts", "kernel": "tpt_svf_scan",
            "coef_path": "sweep"} in c.explain()
