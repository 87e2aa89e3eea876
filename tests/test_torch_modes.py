"""Block mode against sample mode inside oscen_tpu_torch, on the CPU, at
the JAX package's own bounds: the counterparts of
``tests/test_block_mode.py:15-109`` (the README synth, the ADSR closed
forms, the poly synth with events, the feedback island, the Delay node),
``tests/test_multirate.py:196-203`` (the 4x saturator) and
``tests/test_electric_piano.py:371-389`` (K2, the exact-op-order additive
kernel, against sample mode: its plain twin here on the CPU).

Sample mode replays the reference's per-sample schedule; block mode is the
vectorized path.  They share only the IR and the nodes' float32 helpers.
"""

import numpy as np
from test_torch_sample_mode import _readme

import oscen_tpu_torch as T
from oscen_tpu_torch.models.electric_piano import build_electric_piano
from oscen_tpu_torch.models.poly_synth import build_poly_synth
from oscen_tpu_torch.models.simple import build_saturator
from oscen_tpu_torch.ops.cuda import additive as tadd


def _c(g, sr, B, mode):
    return g.compile(sr, block_size=B, mode=mode, device="cpu")


def _rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def test_readme_synth_modes_agree():
    a = _c(_readme(T), 44100.0, 256, "sample").render_mono(2048)
    b = _c(_readme(T), 44100.0, 256, "block").render_mono(2048)
    assert np.abs(a).max() > 0.1
    assert _rms(a, b) < 1e-4


def test_adsr_block_closed_form_matches_scan():
    """Attack across blocks, a release mid-block, a retrigger while
    decaying: max abs 2e-3."""
    def run(mode):
        g = T.Graph("Env")
        g.input("gate", "event")
        g.output("out", "stream")
        env = g.add("env", T.AdsrEnvelope(0.004, 0.03, 0.6, 0.05))
        g.connect("gate", env.gate)
        g.connect(env.output, "out")
        c = _c(g, 48000.0, 512, mode)
        outs = []
        for block_evs in ([(100, 1.0)], [], [(37, 0.0)],
                          [(200, 0.8), (400, 0.0)], []):
            for off, v in block_evs:
                c.queue_event("gate", off, v)
            outs.append(c.process_block()["out"].numpy())
        return np.concatenate(outs)
    a, b = run("sample"), run("block")
    assert a.max() > 0.5
    assert np.abs(a - b).max() < 2e-3


def test_poly_synth_modes_agree_with_events():
    def run(mode):
        s = _c(build_poly_synth(4), 48000.0, 256, mode)
        for note in (60, 64, 67):
            s.queue_event("midi_in", 10, T.raw_midi_event([0x90, note, 100]))
        first = s.process_block()["audio_out"].numpy()
        s.queue_event("midi_in", 0, T.raw_midi_event([0x80, 64, 0]))
        rest = [s.process_block()["audio_out"].numpy() for _ in range(4)]
        return np.concatenate([first] + rest)
    a, b = run("sample"), run("block")
    assert np.abs(a).max() > 0.02
    assert _rms(a, b) < 2e-3


def test_feedback_island_matches_sample_mode():
    """gain -> inline delay (via=24) -> gain: a scan island in block mode
    (the via's Delay makes no promise); atol 1e-6."""
    def run(mode):
        g = T.Graph("FB")
        g.input("x", "stream")
        g.output("out", "stream")
        mix = g.add("mix", T.Gain(1.0))
        fb = g.add("fb", T.Gain(0.6))
        g.connect("x", mix.input)
        g.connect(mix.output, fb.input)
        g.connect(fb.output, mix.input, via=24)
        g.connect(mix.output, "out")
        c = _c(g, 48000.0, 128, mode)
        x = np.zeros(512, np.float32)
        x[0], x[200] = 1.0, -0.5
        return c, c.render_mono(512, stream_inputs={"x": x})
    (_, a), (cb, b) = run("sample"), run("block")
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert abs(a[26] - 0.6) < 1e-6   # the first echo: 24 + the carry
    assert {e["path"] for e in cb.explain() if e["node"] == "mix"} \
        == {"scan_island"}


def test_delay_feedback_node_block_mode():
    """A Delay's own feedback, no promise: block mode scans its tick, equal
    to sample mode bit for bit."""
    def run(mode):
        g = T.Graph("D")
        g.input("x", "stream")
        g.output("out", "stream")
        d = g.add("d", T.Delay(16.0, 0.5))
        g.connect("x", d.input)
        g.connect(d.output, "out")
        x = np.zeros(192, np.float32)
        x[0] = 1.0
        return _c(g, 48000.0, 64, mode).render_mono(
            192, stream_inputs={"x": x})
    a = run("sample")
    np.testing.assert_array_equal(a, run("block"))
    assert a[17] == 1.0 and a[34] == 0.5   # offset 16 past the newest


def test_multirate_modes_agree():
    a = _c(build_saturator(4), 48000.0, 256, "sample").render_mono(1024)
    b = _c(build_saturator(4), 48000.0, 256, "block").render_mono(1024)
    assert np.abs(a).max() > 0.5
    assert _rms(a, b) < 1e-3


def test_additive_parity_kernel_matches_sample_mode(monkeypatch):
    """K2's anchor: ``OSCEN_ADDITIVE_KERNEL=parity`` routes the piano's
    steady blocks through the exact-op-order kernel (its plain twin on the
    CPU); against sample mode the chord render agrees at RMS < 5e-6, the
    JAX package's bound (tests/test_electric_piano.py:371-389)."""
    monkeypatch.setenv("OSCEN_ADDITIVE_KERNEL", "parity")
    calls = []
    real = tadd.plain_parity

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tadd, "plain_parity", counting)

    def run(mode):
        p = _c(build_electric_piano(4), 48000.0, 256, mode)
        for note in (60, 64, 67):
            p.queue_event("midi_in", 0, T.raw_midi_event([0x90, note, 100]))
        p.process_block()   # event block (composed path in block mode)
        return np.concatenate([p.process_block()["out"].numpy()
                               for _ in range(4)])
    a = run("block")
    assert len(calls) == 4          # every steady block ran the parity path
    b = run("sample")
    assert len(calls) == 4          # sample mode runs no kernel
    assert np.abs(b).max() > 0.3
    assert _rms(a, b) < 5e-6
