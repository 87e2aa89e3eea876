"""``nih_params`` (``utils/params.py``), the streaming host
(``utils/host.py``) and the profiler helpers (``utils/profile.py``) of
oscen_tpu_torch on the CPU, and the public names of the port.

- ``nih_params`` / ``FloatParam`` equal the JAX package's bit for bit
  (the same float64 host arithmetic), and ``sync_to`` sets the same host
  ramps; the nih cases of ``tests/test_models_aux.py`` run on the port.
- The cases of ``tests/test_streaming_host.py`` run on the port.  The
  CPU checks the host's mechanics (live events sound where they were
  queued, any pipeline depth hands back ``process_block``'s audio, the
  deadline accounting is consistent); whether the port keeps up in real
  time is a question for the card (``tests/test_torch_cuda.py``): the
  CPU runs the scans' plain versions, a Python loop per sample.
- The port's ``__all__`` holds every name of ``oscen_tpu.__all__``.
"""

import math

import numpy as np
import pytest

import oscen_tpu as J
import oscen_tpu_torch as T

SR = 48000.0


def test_port_exports_every_public_name_of_the_jax_package():
    assert set(J.__all__) <= set(T.__all__)
    for name in T.__all__:
        assert getattr(T, name) is not None


def _echoish(pkg):
    g = pkg.Graph("Echoish")
    g.input("delay_time", "value", default=0.25,
            spec=pkg.ParamSpec(min=0.01, max=1.0, smoother_ms=50.0,
                               unit="s"))
    g.input("filter_cutoff", "value", default=4000.0,
            spec=pkg.ParamSpec(min=100.0, max=10000.0, center=1000.0,
                               unit="Hz"))
    g.input("mix", "value", default=0.5,
            spec=pkg.ParamSpec(min=0.0, max=1.0, ramp_frames=64))
    g.input("semitones", "value", default=0.0,
            spec=pkg.ParamSpec(min=-12.0, max=12.0, step=1.0))
    g.input("plain", "value", default=0.3)
    g.output("out", "stream")
    o = g.add("o", pkg.Oscillator.sine(220.0, 0.5))
    amp = g.add("amp", pkg.Gain(1.0))
    g.connect(o.output, amp.input)
    g.connect("mix", amp.gain)
    g.connect(amp.output, "out")
    return g


def test_nih_params_generation_and_sync():
    g = _echoish(T)
    p = T.nih_params(g)
    jp = J.nih_params(_echoish(J))
    assert p.names() == jp.names()
    assert set(p.names()) == {"delay_time", "filter_cutoff", "mix",
                              "semitones", "plain"}
    assert p.filter_cutoff.display_name == "Filter Cutoff"
    assert abs(p.filter_cutoff.unnormalize(0.5) - 1000.0) < 1e-3
    assert abs(p.filter_cutoff.normalize(1000.0) - 0.5) < 1e-6
    for v in (100.0, 350.0, 4000.0, 10000.0):
        assert abs(p.filter_cutoff.unnormalize(
            p.filter_cutoff.normalize(v)) - v) < 1e-2
    assert p.plain.min == 0.0 and p.plain.max == 1.0
    p.semitones.set_value(3.4)
    assert p.semitones.value() == 3.0
    p.semitones.set_normalized(0.5)
    assert p.semitones.value() == 0.0
    assert p.delay_time.unit == "s"
    # every field and mapping equals the JAX package's
    for a, b in zip(jp, p):
        assert (b.name, b.display_name, b.min, b.max, b.unit, b.step,
                b.smoother_ms, b.ramp_frames, b.factor, b.default) == (
            a.name, a.display_name, a.min, a.max, a.unit, a.step,
            a.smoother_ms, a.ramp_frames, a.factor, a.default)
        for v in np.linspace(b.min - 1, b.max + 1, 23):
            assert b.normalize(v) == a.normalize(v)
        for n in np.linspace(-0.1, 1.1, 25):
            assert b.unnormalize(n) == a.unnormalize(n)
        assert repr(b) == repr(a)

    c = g.compile(SR, block_size=64, device="cpu")
    jc = _echoish(J).compile(SR, block_size=64)
    for params, comp in ((p, c), (jp, jc)):
        params.mix.set_value(1.0)
        params.plain.set_value(0.9)
        params.delay_time.set_value(0.75)
        params.sync_to(comp)
    assert c._params["plain"].frames_remaining == 0
    assert float(c._params["plain"].current) == np.float32(0.9)
    assert c._params["mix"].frames_remaining == 64
    assert c._params["delay_time"].frames_remaining == 2400
    for name, r in c._params.items():
        q = jc._params[name]
        assert (r.current, r.target, r.increment, r.frames_remaining) == (
            q.current, q.target, q.increment, q.frames_remaining)
    out = c.render_mono(128)
    assert np.isfinite(out).all()


def test_nih_params_center_validation():
    with pytest.raises(ValueError):
        T.FloatParam("bad", 1.0, T.ParamSpec(min=0.0, max=1.0, center=1.0))
    with pytest.raises(ValueError):
        T.FloatParam("bad", 1.0, T.ParamSpec(min=1.0, max=1.0))
    p = T.FloatParam("f", 1000.0, T.ParamSpec(min=20.0, max=20000.0,
                                              log=True))
    assert abs(p.unnormalize(0.5) - math.sqrt(20.0 * 20000.0)) < 1.0
    jp = J.FloatParam("f", 1000.0, J.ParamSpec(min=20.0, max=20000.0,
                                               log=True))
    assert p.factor == jp.factor


def test_dsl_nih_spec_fields_roundtrip():
    src = """
        name: P;
        input cutoff: value = 1000.0
            [100.0..10000.0, center: 1000.0, smoother: 50.0, unit: Hz];
        input mix: value = 0.5 [0.0..1.0, ramp: 64];
        output out: stream;
        nodes { osc = Oscillator::sine(220.0, 0.5); }
        connections { osc.output -> out; }
    """
    p = T.nih_params(T.parse_graph(src))
    jp = J.nih_params(J.parse_graph(src))
    assert abs(p.cutoff.unnormalize(0.5) - 1000.0) < 1e-3
    assert p.cutoff.smoother_ms == 50.0
    assert p.cutoff.unit == "Hz"
    assert p.mix.ramp_frames == 64
    assert [repr(x) for x in p] == [repr(x) for x in jp]


def test_param_specs_export():
    g = T.Graph("Specs")
    g.input("cutoff", "value", default=1000.0,
            spec=T.ParamSpec(min=20.0, max=20000.0, log=True, unit="Hz"))
    g.input("gain", "value", default=0.5)
    specs = g.param_specs()
    assert specs["cutoff"].log and specs["cutoff"].unit == "Hz"
    assert "gain" in specs


# ------------------------------------------------------------------ #
# the streaming host (tests/test_streaming_host.py)
# ------------------------------------------------------------------ #
def test_streaming_host_sustains_realtime_with_live_events():
    from oscen_tpu_torch.models.poly_synth import build_poly_synth
    from oscen_tpu_torch.utils.host import StreamingHost

    synth = build_poly_synth(4).compile(SR, block_size=128, mode="block",
                                        device="cpu")
    synth.queue_event("midi_in", 0, T.raw_midi_event([0x90, 60, 100]))
    synth.process_block()
    synth.process_block()
    synth.init()

    host = StreamingHost(synth, realtime=False)
    fired = {"on": False, "off": False}

    def on_block(h, t):
        if not fired["on"] and t >= 0.05:
            h.compiled.queue_event("midi_in", 3,
                                   T.raw_midi_event([0x90, 69, 110]))
            fired["on"] = True
        if not fired["off"] and t >= 0.35:
            h.compiled.queue_event("midi_in", 0,
                                   T.raw_midi_event([0x80, 69, 0]))
            fired["off"] = True

    audio = host.run(0.5, on_block=on_block)
    r = host.report()
    assert r["blocks"] == int(round(0.5 * SR / 128))
    assert r["sustained_rtf"] == pytest.approx(
        r["block_period_ms"] / r["block_ms_median"])
    assert r["staging_ms_median"] > 0.0
    assert audio.shape == (r["blocks"] * 128,)
    assert np.isfinite(audio).all()
    assert np.abs(audio[: int(0.04 * SR)]).max() < 1e-6
    assert np.abs(audio[int(0.1 * SR):int(0.3 * SR)]).max() > 0.05


def test_streaming_host_deadline_accounting(capsys):
    from oscen_tpu_torch.models.poly_synth import build_poly_synth
    from oscen_tpu_torch.utils.host import StreamingHost

    synth = build_poly_synth(2).compile(SR, block_size=512, mode="block",
                                        device="cpu")
    synth.process_block()
    host = StreamingHost(synth, realtime=True)
    assert host.run(0.25, collect=False) is None
    r = host.report()
    for key in ("blocks", "block_period_ms", "staging_ms_median",
                "block_ms_median", "deadline_misses", "worst_margin_ms",
                "sustained_rtf", "throughput_rtf"):
        assert key in r
    assert 0 <= r["deadline_misses"] <= r["blocks"] == 23
    assert (r["deadline_misses"] > 0) == (r["worst_margin_ms"] < 0), r
    host.print_report()
    assert "deadline misses" in capsys.readouterr().out


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_streaming_host_pipelining_keeps_the_audio(depth):
    """Any pipeline depth hands back the same audio as process_block."""
    from oscen_tpu_torch.models.simple import build_simple_synth
    from oscen_tpu_torch.utils.host import StreamingHost

    a = build_simple_synth().compile(SR, block_size=256, device="cpu")
    b = build_simple_synth().compile(SR, block_size=256, device="cpu")
    host = StreamingHost(a, realtime=False, pipeline_depth=depth)
    got = host.run(256 * 6 / SR)
    want = np.concatenate([b.process_block()["out"].numpy()
                           for _ in range(6)])
    np.testing.assert_array_equal(got, want)


def test_measure_rtf_and_trace(tmp_path):
    from oscen_tpu_torch.models.simple import build_simple_synth
    from oscen_tpu_torch.utils.profile import measure_rtf, trace

    c = build_simple_synth().compile(SR, block_size=256, device="cpu")
    r = measure_rtf(c, n_blocks=16, trials=2)
    assert r["frames"] == (16 - 2) * 256
    assert r["rtf"] > 0 and r["us_per_block"] > 0
    with trace(str(tmp_path / "tr")) as prof:
        c.process_block()
    assert prof is not None
    assert any((tmp_path / "tr").iterdir())
