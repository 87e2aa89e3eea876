"""Checkpoints (``utils/checkpoint.py``) and bundles (``utils/bundle.py``) of
oscen_tpu_torch on the CPU.

The checkpoint cases of ``tests/test_models_aux.py`` and the cases of
``tests/test_bundle.py`` run on the port, each beside the JAX package's
run of the same performance: a restore continues bit for bit within the
port (``assert_array_equal``), and the port's continuation stays within
the slice's bound of the JAX package's.  A Convolver restored mid-fade
takes its host fade mirror from the checkpoint.
"""

import json
import os

import numpy as np
import pytest

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.utils import checkpoint as jckpt
from oscen_tpu_torch.utils.bundle import load_bundle, save_bundle
from oscen_tpu_torch.utils.checkpoint import load_state, save_state
from oscen_tpu_torch.utils.convert import state_from_jax, state_to_numpy

SR = 48000.0


def _compile(pkg, g, B, mode="block"):
    kw = {"device": "cpu"} if pkg is T else {}
    return g.compile(SR, block_size=B, mode=mode, **kw)


def test_checkpoint_restore():
    """State is a tree of tensors: copying it out and back reproduces a
    bit-identical continuation."""
    from oscen_tpu_torch.models.simple import build_simple_synth
    c = _compile(T, build_simple_synth(), 256, mode="sample")
    c.render_mono(512)
    saved = state_to_numpy(c.state)
    a = c.render_mono(512)
    c.state = state_from_jax(saved, device="cpu")
    b = c.render_mono(512)
    np.testing.assert_array_equal(a, b)


def _poly_ckpt(pkg):
    N = 4
    g = pkg.Graph("PolyCkpt")
    g.input("midi_in", "event")
    g.output("out", "stream")
    parser = g.add("parser", pkg.MidiParser())
    alloc = g.add("alloc", pkg.VoiceAllocator(N))
    handlers = g.add("handlers", pkg.MidiVoiceHandler(), count=N)
    envs = g.add("envs", pkg.AdsrEnvelope(0.001, 0.01, 1.0, 0.05), count=N)
    oscs = g.add("oscs", pkg.Oscillator.sine(440.0, 0.25), count=N)
    mix = g.add("mix", pkg.Gain(1.0))
    g.connect("midi_in", parser.midi_in)
    g.connect(parser.note_on, alloc.note_on)
    g.connect(parser.note_off, alloc.note_off)
    g.connect(alloc.voices, handlers.note_on)
    g.connect(alloc.voices, handlers.note_off)
    g.connect(handlers.gate, envs.gate)
    g.connect(handlers.frequency, oscs.frequency)
    g.connect(oscs.output * envs.output, mix.input)
    g.connect(mix.output, "out")
    return g


@pytest.mark.parametrize("mode", ["block", "sample"])
def test_checkpoint_restores_host_domain_state(tmp_path, mode):
    """A mid-performance checkpoint of a polyphonic graph restored into a
    fresh compile continues identically: voice allocation, MIDI note
    tracking, pending events, and more events after the restore.  The
    port's continuation stays within 1e-5 of the JAX package's."""
    ev = T.raw_midi_event

    def perform(pkg, path, save):
        c1 = _compile(pkg, _poly_ckpt(pkg), 128, mode)
        for note in (60, 64, 67, 72):
            c1.queue_event("midi_in", 0, pkg.raw_midi_event(
                [0x90, note, 100]))
        c1.render_mono(1024 if mode == "block" else 256)
        c1.queue_event("midi_in", 0, pkg.raw_midi_event([0x80, 64, 0]))
        c1.render_mono(256)
        c1.queue_event("midi_in", 7, pkg.raw_midi_event([0x90, 76, 90]))
        save(c1, path)
        return c1

    path = str(tmp_path / "ckpt.pkl")
    c1 = perform(T, path, save_state)
    a = c1.render_mono(512)
    c2 = _compile(T, _poly_ckpt(T), 128, mode)
    load_state(c2, path)
    b = c2.render_mono(512)
    np.testing.assert_array_equal(a, b)
    for c in (c1, c2):
        c.queue_event("midi_in", 3, ev([0x90, 48, 110]))
    a2, b2 = c1.render_mono(256), c2.render_mono(256)
    np.testing.assert_array_equal(a2, b2)
    j1 = perform(J, str(tmp_path / "j.pkl"), jckpt.save_state)
    ja = np.asarray(j1.render_mono(512))
    np.testing.assert_allclose(a, ja, atol=1e-5, rtol=0)


def test_checkpoint_rejects_mismatched_config(tmp_path):
    from oscen_tpu_torch.models.poly_synth import build_poly_synth
    from oscen_tpu_torch.nodes.midi import MidiVoiceHandler

    path = str(tmp_path / "ck.pkl")
    c8 = _compile(T, build_poly_synth(8), 64)
    c8.queue_event("midi_in", 0, T.raw_midi_event([0x90, 60, 100]))
    c8.process_block()
    save_state(c8, path)
    c16 = _compile(T, build_poly_synth(16), 64)
    c16.ir.name = c8.ir.name
    with pytest.raises(ValueError):
        load_state(c16, path)
    other = _compile(T, build_poly_synth(8), 64)
    other.ir.name = "Other"
    with pytest.raises(ValueError, match="checkpoint is for graph"):
        load_state(other, path)
    h = MidiVoiceHandler()
    snap = h.host_state()
    snap["INPUTS"] = "garbage"
    h.restore_host_state(snap)
    assert h.INPUTS != "garbage"


def _reverb(pkg, B=64, channels=2, max_ir=128):
    g = pkg.Graph("Reverb")
    g.input("x", "stream", channels=channels)
    g.output("out", "stream", channels=channels)
    g.external("ir")
    c = g.add("conv", pkg.Convolver(max_ir_len=max_ir, channels=channels))
    g.connect("ir", c.ir)
    g.connect("x", c.input)
    g.connect(c.output, "out")
    return _compile(pkg, g, B)


def test_checkpoint_restores_the_convolver_mid_fade(tmp_path):
    """Saved 320 samples into a 960-sample fade (after a capacity growth
    from 128 to 256 taps): restored into a fresh graph compiled at the
    grown capacity (a graph at the old one has other shapes and is
    refused), the host mirror is the saved ``fade_pos`` (the fade branch
    keeps running), and it continues bit for bit through the end of the
    fade and past it."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2560, 2)).astype(np.float32)
    ir = rng.uniform(-1, 1, (2, 200)).astype(np.float32)
    c1 = _reverb(T)
    c1.render(256, stream_inputs={"x": x[:256]})
    c1.publish_asset("ir", T.AudioAsset.from_samples(ir, 48000))
    c1.render(320, stream_inputs={"x": x[256:576]})
    assert c1._mirrors == {"conv": {"fade_pos": 320}}
    path = str(tmp_path / "rv.pkl")
    save_state(c1, path)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_state(_reverb(T), path)
    c2 = _reverb(T, max_ir=256)
    assert c2._mirrors == {"conv": {"fade_pos": 960}}
    load_state(c2, path)
    assert c2._mirrors == {"conv": {"fade_pos": 320}}
    assert tuple(c2.state["conv"]["fdl"].shape) == (4, 65, 2)
    a = c1.render(1984, stream_inputs={"x": x[576:]})["out"]
    b = c2.render(1984, stream_inputs={"x": x[576:]})["out"]
    np.testing.assert_array_equal(a, b)
    assert c2._mirrors == {"conv": {"fade_pos": 960}}


# ------------------------------------------------------------------ #
# bundles (tests/test_bundle.py)
# ------------------------------------------------------------------ #
def test_bundle_roundtrip_mid_performance(tmp_path):
    from oscen_tpu.models.electric_piano import build_electric_piano as jep
    from oscen_tpu_torch.models.electric_piano import build_electric_piano

    def perform(pkg, build):
        s = _compile(pkg, build(4), 256)
        s.queue_event("midi_in", 0, pkg.raw_midi_event([0x90, 60, 100]))
        s.queue_event("midi_in", 0, pkg.raw_midi_event([0x90, 67, 90]))
        s.render(512)
        s.set_value("vibrato_speed", 7.5)
        s.queue_event("midi_in", 3, pkg.raw_midi_event([0x80, 60, 0]))
        return s
    s = perform(T, build_electric_piano)
    p = os.path.join(tmp_path, "ep")
    save_bundle(s, p)
    s2 = load_bundle(p, device="cpu")
    assert s2.device.type == "cpu" and s2.mode == "block"
    a = s.render(1024)["out"]
    b = s2.render(1024)["out"]
    np.testing.assert_array_equal(a, b)
    j = np.asarray(perform(J, jep).render(1024)["out"])
    np.testing.assert_allclose(a, j, atol=1e-4, rtol=0)


def test_bundle_manifest_contents(tmp_path):
    from oscen_tpu_torch.core.types import ParamSpec

    def build(pkg, spec):
        g = pkg.Graph("Mani")
        g.input("cutoff", "value", default=900.0,
                spec=spec(min=20.0, max=20000.0, log=True, unit="Hz"))
        g.output("out", "stream")
        o = g.add("osc", pkg.PolyBlepOscillator.saw(220.0, 0.5))
        f = g.add("f", pkg.TptFilter(900.0, 0.707))
        g.connect("cutoff", f.cutoff)
        g.connect(o.output, f.input)
        g.connect(f.output, "out")
        kw = {"device": "cpu"} if pkg is T else {}
        return g.compile(44100.0, block_size=128, **kw)
    p = os.path.join(tmp_path, "m")
    save_bundle(build(T, ParamSpec), p)
    m = json.load(open(os.path.join(p, "manifest.json")))
    assert m["graph"] == "Mani"
    assert m["sample_rate"] == 44100.0
    assert m["block_size"] == 128
    assert {i["name"] for i in m["inputs"]} == {"cutoff"}
    assert m["params"]["cutoff"]["log"] is True
    assert m["params"]["cutoff"]["unit"] == "Hz"
    assert any(n.startswith("TptFilter") for n in m["nodes"])
    from oscen_tpu.utils.bundle import save_bundle as jsave
    pj = os.path.join(tmp_path, "mj")
    jsave(build(J, J.ParamSpec), pj)
    assert json.load(open(os.path.join(pj, "manifest.json"))) == m


def test_bundle_format_version_checked(tmp_path):
    g = T.Graph("V")
    g.output("out", "stream")
    o = g.add("osc", T.PolyBlepOscillator.saw(220.0, 0.5))
    g.connect(o.output, "out")
    s = g.compile(44100.0, block_size=64, device="cpu")
    p = os.path.join(tmp_path, "v")
    save_bundle(s, p)
    m = json.load(open(os.path.join(p, "manifest.json")))
    m["format"] = 999
    json.dump(m, open(os.path.join(p, "manifest.json"), "w"))
    with pytest.raises(ValueError, match="bundle format"):
        load_bundle(p, device="cpu")


def test_bundle_of_a_reverb_with_its_published_ir(tmp_path):
    """A bundle carries the published IR, the spectra and the fade
    position: loaded with ``jit=`` (accepted, without meaning in the
    port), it continues bit for bit; without a card the default device
    raises."""
    x = np.random.default_rng(6).uniform(-1, 1, (1024, 2)).astype(
        np.float32)
    s = _reverb(T)
    s.publish_asset("ir", T.AudioAsset.from_samples(
        np.random.default_rng(7).uniform(-1, 1, 120).astype(np.float32),
        48000))
    s.render(512, stream_inputs={"x": x[:512]})
    p = os.path.join(tmp_path, "rv")
    save_bundle(s, p)
    s2 = load_bundle(p, jit=False, device="cpu")
    a = s.render(512, stream_inputs={"x": x[512:]})["out"]
    b = s2.render(512, stream_inputs={"x": x[512:]})["out"]
    np.testing.assert_array_equal(a, b)
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            load_bundle(p)
