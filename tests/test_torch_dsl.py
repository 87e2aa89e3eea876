"""oscen_tpu_torch's textual graph DSL (``parse_graph``,
``parse_oversample_variants``) and the public names that came with it,
against the JAX package on the CPU.

- Every source of tests/test_dsl.py's error tests gives the same
  ``GraphError`` message through both parsers.
- The README synth parsed by the port equals the port's builder graph bit
  for bit, and is within the README synth's 1e-5 of the JAX package's
  parsed render (tests/test_torch_poly_synth.py).
- The ``Sat_1x`` / ``Sat_4x`` variants are within the saturator's 1e-6 of
  the JAX package's (tests/test_torch_echo_saturator.py).
- What the port lacks fails where it would: a type outside the registry
  is an unknown node type at parse time; the ``Convolver`` (ported since
  the asset slice) parses and renders as the JAX package's; an inline via
  runs (a scan island).
- ``Value``, ``AudioInput``, ``EventPassthrough``, ``EventQueue`` and the
  ``EventBuffer`` helpers against their JAX counterparts.
"""

import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.graph.dsl import parse_graph as jparse
from oscen_tpu.graph.dsl import parse_oversample_variants as jvariants

SR = 48000.0

README_SYNTH = """
    name: Synth;

    input mod_freq: value = 5.0;
    input mod_depth: value = 0.2;
    input carrier_freq: value = 440.0;
    input cutoff: value = 1200.0;

    output audio_out: stream;

    nodes {
        modulator = PolyBlepOscillator::sine(5.0, 0.2);
        carrier = PolyBlepOscillator::saw(440.0, 0.5);
        filter = TptFilter::new(1200.0, 0.707);
    }

    connections {
        mod_freq -> modulator.frequency;
        mod_depth -> modulator.amplitude;
        carrier_freq -> carrier.frequency;
        cutoff -> filter.cutoff;
        modulator.output -> carrier.frequency_mod;
        carrier.output -> filter.input;
        filter.output -> audio_out;
    }
"""

# the sources of tests/test_dsl.py:120-217
ERROR_SOURCES = {
    "unknown_type": "nodes { x = NoSuchNode::new(); }",
    "missing_colon": "input x value;",
    "no_endpoint": """
        output out: stream;
        nodes { o = Oscillator::sine(100.0, 1.0); }
        connections { o.nope -> out; }
    """,
    "two_top_level": """
        name: TwoBadItems;
        input s1: stream
        input s2: stream;
        output out: stream;
        foo bar baz;
        connections { s1 -> out; }
    """,
    "two_node_block": """
        name: BadNodeBlock;
        output out: stream;
        nodes {
            osc = PolyBlepOscillator::saw(440.0, 0.6)
            lfo = PolyBlepOscillator::sine(2.0, 0.5);
            amp : 0.8;
        }
        connections { lfo.output -> out; }
    """,
    "two_connection_block": """
        name: BadConnectionBlock;
        input s1: stream;
        input s2: stream;
        input s3: stream;
        output out: stream;
        connections {
            s1 = out;
            s2 -> out;
            s3 -> ;
        }
    """,
    "misplaced_name": """
        input s: stream;
        name: LateName;
        output out: stream;
        connections { s -> out; }
    """,
    "application_errors": """
        output out: stream;
        nodes { o = Oscillator::sine(100.0, 1.0); }
        connections {
            o.nope -> out;
            o.alsonope -> out;
        }
    """,
    "bad_chars": """
        output out: stream;
        nodes { o = Oscillator~sine(100.0, 1.0); }
    """,
    "empty_factors": "base_name: X; factors: []; body: { output o: stream; }",
    "unterminated_body": "base_name: X; factors: [2]; body: { output o: "
                         "stream;",
}


def _message(parse, src):
    with pytest.raises(Exception) as ei:
        parse(src)
    assert type(ei.value).__name__ == "GraphError"
    return str(ei.value)


@pytest.mark.parametrize("case", sorted(ERROR_SOURCES))
def test_error_messages_match_jax(case):
    src = ERROR_SOURCES[case]
    variants = case in ("empty_factors", "unterminated_body")
    j = _message(jvariants if variants else jparse, src)
    t = _message(T.parse_oversample_variants if variants else T.parse_graph,
                 src)
    assert t == j


def _readme_builder():
    """The README synth through the port's builder API
    (tests/test_graph_basic.py build_readme_synth)."""
    g = T.Graph("Synth")
    for name, v in (("mod_freq", 5.0), ("mod_depth", 0.2),
                    ("carrier_freq", 440.0), ("cutoff", 1200.0)):
        g.input(name, "value", default=v)
    g.output("audio_out", "stream")
    modulator = g.add("modulator", T.PolyBlepOscillator.sine(5.0, 0.2))
    carrier = g.add("carrier", T.PolyBlepOscillator.saw(440.0, 0.5))
    filt = g.add("filter", T.TptFilter(1200.0, 0.707))
    g.connect("mod_freq", modulator.frequency)
    g.connect("mod_depth", modulator.amplitude)
    g.connect("carrier_freq", carrier.frequency)
    g.connect("cutoff", filt.cutoff)
    g.connect(modulator.output, carrier.frequency_mod)
    g.connect(carrier.output, filt.input)
    g.connect(filt.output, "audio_out")
    return g


def test_readme_synth_matches_builder_and_jax():
    parsed = T.parse_graph(README_SYNTH)
    assert parsed.name == "Synth"
    a = parsed.compile(SR, block_size=256, device="cpu").render_mono(2048)
    b = _readme_builder().compile(SR, block_size=256,
                                  device="cpu").render_mono(2048)
    np.testing.assert_array_equal(a, b)
    j = np.asarray(jparse(README_SYNTH).compile(SR, block_size=256)
                   .render_mono(2048))
    assert np.abs(j).max() > 0.1
    np.testing.assert_allclose(a, j, atol=1e-5, rtol=0)


def test_oversample_variants_match_jax():
    src = """
        base_name: Sat;
        factors: [1, 4];
        body: {
            output audio_out: stream;
            nodes {
                osc = PolyBlepOscillator::saw(2000.0, 0.6) * {FACTOR};
                clip = HardClip::new() * { FACTOR };
            }
            connections {
                osc.output * 2.0 -> clip.input;
                [sinc] clip.output -> audio_out;
            }
        }
    """
    tv, jv = T.parse_oversample_variants(src), jvariants(src)
    assert sorted(tv) == sorted(jv) == ["Sat_1x", "Sat_4x"]
    outs = {}
    for name in tv:
        a = tv[name].compile(SR, block_size=256,
                             device="cpu").render_mono(2048)
        j = np.asarray(jv[name].compile(SR, block_size=256)
                       .render_mono(2048))
        np.testing.assert_allclose(a, j, atol=1e-6, rtol=0)
        outs[name] = a
    assert tv["Sat_4x"].lower().nodes["clip"].rate == 4
    assert not np.array_equal(outs["Sat_1x"], outs["Sat_4x"])


def test_what_the_port_lacks_fails_where_it_would():
    """A type outside the registry is an unknown type at parse time, with
    the unknown-type message, in both parsers; a Convolver (ported with
    the assets) parses, binds its ``external`` and renders within 1e-5 of
    the JAX package's parse; an inline via, which lowers to a Delay with
    no promise on a cycle, runs as a scan island and matches the JAX
    package's parse at 1e-6."""
    bad = "nodes { conv = Reverb::new(max_ir_len=64); }"
    msg = _message(T.parse_graph, bad)
    assert msg == _message(J.parse_graph, bad) == \
        "DSL: unknown node type 'Reverb' (pass it in the registry)"
    src = """
        input x: stream;
        output out: stream;
        external ir;
        nodes { conv = Convolver::new(max_ir_len=64); }
        connections { ir -> conv.ir; x -> conv.input; conv.output -> out; }
    """
    x = np.random.default_rng(0).uniform(-1, 1, 512).astype(np.float32)
    ir = np.random.default_rng(1).uniform(-1, 1, 40).astype(np.float32)
    outs = []
    for pkg, kw in ((T, {"device": "cpu"}), (J, {})):
        g = pkg.parse_graph(src)
        assert g.lower().asset_bindings == [("ir", "conv", "ir")]
        c = g.compile(SR, block_size=128, **kw)
        c.publish_asset("ir", pkg.AudioAsset.from_samples(ir, 48000))
        outs.append(np.asarray(c.render_mono(512, stream_inputs={"x": x})))
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5, rtol=0)
    via = """
        output out: stream;
        nodes {
            a = Oscillator::sine(100.0, 1.0);
            b = Oscillator::sine(200.0, 1.0);
            mix = Gain::new(1.0);
        }
        connections {
            a.output * 0.5 + b.output * 0.25 -> mix.input;
            mix.output * 0.5 -> [32] -> mix.input;
            mix.output -> out;
        }
    """
    g = T.parse_graph(via)
    assert any(type(i.node).__name__ == "Delay"
               for i in g.lower().nodes.values())
    b = g.compile(SR, block_size=128, device="cpu").render_mono(512)
    a = np.asarray(jparse(via).compile(SR, block_size=128).render_mono(512))
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)


def test_value_audio_input_and_passthrough_match_jax():
    """A graph that uses the new nodes: a Value feeding a filter cutoff, an
    AudioInput turning a value into the oscillator's frequency modulation,
    and an EventPassthrough forwarding gates to an envelope."""
    src = """
        input level: value = 0.4;
        input gate: event;
        output out: stream;
        nodes {
            cut = Value::new(900.0);
            bias = AudioInput::new();
            route = EventPassthrough::new();
            env = AdsrEnvelope::new(0.01, 0.05, 0.7, 0.1);
            osc = PolyBlepOscillator::saw(220.0, 0.5);
            filt = TptFilter::new(1000.0, 0.707);
        }
        connections {
            level -> bias.input_value;
            bias.output -> osc.frequency_mod;
            cut.output -> filt.cutoff;
            gate -> route.input;
            route.output -> env.gate;
            osc.output * env.output -> filt.input;
            filt.output -> out;
        }
    """

    def run(pkg, **kw):
        c = pkg.parse_graph(src).compile(SR, block_size=128, **kw)
        c.queue_event("gate", 5, 1.0)
        a = np.asarray(c.render_mono(512))
        c.set_value("level", 0.1)
        c.queue_event("gate", 40, 0.0)
        return np.concatenate([a, np.asarray(c.render_mono(512))])

    j, t = run(J), run(T, device="cpu")
    assert np.abs(j).max() > 0.05
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)
    assert T.Value(2.0).INPUTS[0].default == J.Value(2.0).INPUTS[0].default
    assert [e.name for e in T.AudioInput.OUTPUTS] == \
        [e.name for e in J.AudioInput.OUTPUTS]


def test_event_queue_and_buffers_match_jax():
    """EventQueue drops what overflows its capacity; EventBuffer.empty,
    pad_to and stack give the JAX package's arrays (numpy), and pad_to /
    stack keep tensors as tensors."""
    evs = [T.scalar_event(o, v) for o, v in ((9, 0.5), (3, 1.0), (9, 0.0))]
    jevs = [J.scalar_event(o, v) for o, v in ((9, 0.5), (3, 1.0), (9, 0.0))]
    tq, jq = T.EventQueue(capacity=2), J.EventQueue(capacity=2)
    assert [tq.try_push(e) for e in evs] == [jq.try_push(e) for e in jevs] \
        == [True, True, False]
    assert len(tq) == len(jq) == 2 and list(tq)[1].frame_offset == 3
    tq.clear()
    assert len(tq) == 0

    def same(tb, jb):
        for f in ("offsets", "values", "valid"):
            a, b = np.asarray(getattr(tb, f)), np.asarray(getattr(jb, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    same(T.EventBuffer.empty(4), J.EventBuffer.empty(4))
    tb = [T.EventBuffer.from_events(evs[:k], 2 + k) for k in range(3)]
    jb = [J.EventBuffer.from_events(jevs[:k], 2 + k) for k in range(3)]
    same(tb[1].pad_to(6), jb[1].pad_to(6))
    same(T.EventBuffer.stack(tb), J.EventBuffer.stack(jb))
    with pytest.raises(ValueError, match="shrink"):
        tb[2].pad_to(1)
    tt = [T.EventBuffer(torch.as_tensor(b.offsets),
                        torch.as_tensor(b.values),
                        torch.as_tensor(b.valid)) for b in tb]
    st = T.EventBuffer.stack(tt)
    assert isinstance(st.offsets, torch.Tensor)
    same(st, J.EventBuffer.stack(jb))
