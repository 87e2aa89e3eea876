"""The ``SamplePlayer`` and the ``Oscilloscope`` of oscen_tpu_torch against
the JAX package on the CPU, bit for bit.

The sample-player cases of ``tests/test_assets_convolution.py`` and the
oscilloscope cases of ``tests/test_models_aux.py`` run through both
packages; the port's outputs and states equal the JAX package's
(``assert_array_equal``; the sum of a node array's outputs at the graph
output within 1e-6) in block and sample mode: playback is a gather at
modular indices, the scope a ring write and integer reductions.  A block
longer than the scope's ring writes only its last ``capacity`` samples,
and is held against the JAX package's sample mode (the per-sample ring).
"""

import numpy as np
import pytest

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu_torch.utils.convert import state_to_numpy

SR = 48000.0


def _compile(pkg, g, B, mode="block", sr=SR):
    kw = {"device": "cpu"} if pkg is T else {}
    return g.compile(sr, block_size=B, mode=mode, **kw)


def _np_state(pkg, c, name):
    if pkg is T:
        return state_to_numpy(c.state[name])
    import jax
    return jax.tree_util.tree_map(np.asarray, c.state[name])


def sp_graph(pkg, capacity=64, count=1, channels=1):
    g = pkg.Graph("SP")
    g.output("out", "stream", channels=channels)
    g.external("buf")
    sp = g.add("sp", pkg.SamplePlayer(channels=channels, capacity=capacity),
               count=count)
    g.connect("buf", sp.buf)
    g.connect(sp.output, "out")
    return g


@pytest.mark.parametrize("mode", ["block", "sample"])
def test_sample_player_loops_and_swaps(mode):
    data = np.arange(10, dtype=np.float32) / 10.0

    def run(pkg):
        c = _compile(pkg, sp_graph(pkg), 32, mode)
        outs = [c.render_mono(32)]
        c.publish_asset("buf", pkg.AudioAsset.from_samples(data, 48000))
        outs.append(c.render_mono(25))
        c.publish_asset("buf", pkg.AudioAsset.from_samples(-data, 48000))
        outs.append(c.render_mono(10))
        return [np.asarray(o) for o in outs], _np_state(pkg, c, "sp")
    (ja, js), (ta, ts) = run(J), run(T)
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(b, a)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k])
    np.testing.assert_array_equal(ta[0], 0.0)
    np.testing.assert_allclose(ta[1], np.tile(data, 3)[:25], atol=1e-6)
    np.testing.assert_allclose(ta[2], -data, atol=1e-6)


def test_sample_player_wav_roundtrip(tmp_path):
    path = str(tmp_path / "test.wav")
    data = (np.sin(np.linspace(0, 20, 200)) * 0.5).astype(np.float32)
    T.AudioAsset.write_wav(path, data, 48000)

    def run(pkg):
        c = _compile(pkg, sp_graph(pkg, capacity=256), 64)
        c.load_wav("buf", path)
        return np.asarray(c.render_mono(200))
    a, b = run(J), run(T)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(b, data, atol=1e-3)  # 16-bit quant


def test_asset_resamples_to_graph_rate():
    """A 1 kHz sine at 44.1 kHz plays as 1 kHz at 48 kHz; the conformed
    buffer and the render equal the JAX package's."""
    sr_src = 44100
    t = np.arange(sr_src // 2, dtype=np.float32)
    data = np.sin(2 * np.pi * 1000.0 * t / sr_src).astype(np.float32)

    def run(pkg):
        c = _compile(pkg, sp_graph(pkg, capacity=1 << 15), 512)
        c.publish_asset("buf", pkg.AudioAsset.from_samples(data, sr_src))
        return np.asarray(c.render_mono(8192))
    a, b = run(J), run(T)
    np.testing.assert_array_equal(b, a)
    out = b[512:7680]
    spec = np.abs(np.fft.rfft(out * np.hanning(len(out))))
    peak = np.fft.rfftfreq(len(out), 1 / SR)[spec.argmax()]
    assert abs(peak - 1000.0) < 10.0, peak


@pytest.mark.parametrize("mode", ["block", "sample"])
def test_sample_player_array_shares_one_asset(mode):
    """[SamplePlayer; 8] bound to one external: the publish broadcasts
    the buffer into every instance, playheads reset on each swap."""
    data = np.arange(10, dtype=np.float32) / 10.0

    def run(pkg):
        c = _compile(pkg, sp_graph(pkg, count=8), 32, mode)
        outs = [c.render_mono(32)]
        c.publish_asset("buf", pkg.AudioAsset.from_samples(data, 48000))
        outs.append(c.render_mono(25))
        c.publish_asset("buf", pkg.AudioAsset.from_samples(-data, 48000))
        outs.append(c.render_mono(10))
        c.publish_asset("buf", pkg.AudioAsset.from_samples(data, 48000))
        outs.append(c.render_mono(10))
        return [np.asarray(o) for o in outs], _np_state(pkg, c, "sp")
    (ja, js), (ta, ts) = run(J), run(T)
    # the graph output sums the 8 instances: XLA and torch add in another
    # order (one rounding of the sum); the instances' states are equal
    for a, b in zip(ja, ta):
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k])
    assert ts["buf"].shape == (8, 64, 1)
    np.testing.assert_array_equal(ta[0], 0.0)
    np.testing.assert_allclose(ta[1], 8.0 * np.tile(data, 3)[:25],
                               atol=1e-5)
    np.testing.assert_allclose(ta[2], -8.0 * data, atol=1e-5)


@pytest.mark.parametrize("channels,src_ch", [(2, 1), (2, 2), (2, 3),
                                             (1, 2), (3, 2)])
def test_sample_player_channel_mapping_matches_jax(channels, src_ch):
    """Mono broadcasts, extra source channels drop, missing ones clamp to
    the last source channel; a loop longer than a block, B=48."""
    rng = np.random.default_rng(channels * 10 + src_ch)
    data = rng.uniform(-1, 1, (src_ch, 70)).astype(np.float32)

    def run(pkg):
        c = _compile(pkg, sp_graph(pkg, capacity=128, channels=channels), 48)
        c.publish_asset("buf", pkg.AudioAsset.from_samples(data, 48000))
        return np.asarray(c.render(200)["out"])
    a, b = run(J), run(T)
    np.testing.assert_array_equal(b, a)


# ------------------------------------------------------------------ #
# the Oscilloscope (tests/test_models_aux.py)
# ------------------------------------------------------------------ #
def scope_graph(pkg, capacity=2048):
    """The tests' sine oscillator into a scope, with the sine made in numpy
    and fed through a stream input: both packages' scopes see the same
    samples (the two oscillators differ by an ulp here and there)."""
    g = pkg.Graph("Scope")
    g.input("x", "stream")
    g.output("out", "stream")
    scope = g.add("scope", pkg.Oscilloscope(capacity=capacity))
    g.connect("x", scope.input)
    g.connect(scope.output, "out")
    return g


def _sine(freq, n):
    return np.sin(2 * np.pi * freq * np.arange(n) / SR).astype(np.float32)


def test_oscilloscope_snapshot_trigger():
    def run(pkg):
        c = _compile(pkg, scope_graph(pkg), 512)
        c.render_mono(2048, stream_inputs={"x": _sine(100.0, 2048)})
        st = _np_state(pkg, c, "scope")
        return st, pkg.Oscilloscope.snapshot(c.node_state("scope"),
                                             length=480)
    (js, jsnap), (ts, tsnap) = run(J), run(T)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k])
    np.testing.assert_array_equal(tsnap, jsnap)
    assert tsnap.shape == (480,)
    assert abs(tsnap[0]) < 0.05 and tsnap[5] > tsnap[0]
    assert abs(tsnap[-1]) < 0.1


def test_oscilloscope_auto_period_detection():
    def run(pkg, bs):
        c = _compile(pkg, scope_graph(pkg), bs)
        c.render_mono(1920, stream_inputs={"x": _sine(250.0, 1920)})
        return c.node_state("scope")
    st = run(T, 512)
    assert int(st["detected_period"]) == 192
    snap = T.Oscilloscope.snapshot(st)
    assert snap.shape == (192,)
    assert 0.0 < snap[-1] < 0.05
    assert 0.05 < snap[0] < 0.1
    st2 = run(T, 128)
    assert int(st2["detected_period"]) == 192
    assert int(st2["period_count"]) == int(st["period_count"])
    for bs in (512, 128):
        js = run(J, bs)
        ts = run(T, bs)
        for k in js:
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
        np.testing.assert_array_equal(T.Oscilloscope.snapshot(ts),
                                      J.Oscilloscope.snapshot(js))


@pytest.mark.parametrize("trigger,length,period", [
    (True, None, None), (False, None, None), (True, 100, None),
    (True, None, 50), (False, 300, None), (True, 3000, None)])
def test_oscilloscope_snapshot_options_match_jax(trigger, length, period):
    def run(pkg):
        c = _compile(pkg, scope_graph(pkg), 256)
        c.render_mono(2560, stream_inputs={"x": _sine(310.0, 2560)})
        return pkg.Oscilloscope.snapshot(c.node_state("scope"),
                                         length=length, trigger=trigger,
                                         period=period)
    np.testing.assert_array_equal(run(T), run(J))


@pytest.mark.parametrize("B", [96, 100, 256])
def test_oscilloscope_block_longer_than_ring(B):
    """A block longer than the ring (capacity 64) writes its last 64
    samples: the port's block mode equals the JAX package's sample mode
    (the per-sample ring), and its own sample mode, bit for bit."""
    def run(pkg, mode):
        g = pkg.Graph("ScopeRing")
        g.input("x", "stream")
        g.output("out", "stream")
        s = g.add("scope", pkg.Oscilloscope(capacity=64))
        g.connect("x", s.input)
        g.connect(s.output, "out")
        c = _compile(pkg, g, B, mode)
        x = np.sin(np.arange(3 * B) * 0.37).astype(np.float32) \
            + np.random.default_rng(B).uniform(-0.3, 0.3, 3 * B).astype(
                np.float32)
        y = np.asarray(c.render_mono(3 * B, stream_inputs={"x": x}))
        return y, _np_state(pkg, c, "scope")
    jy, js = run(J, "sample")
    for mode in ("block", "sample"):
        ty, ts = run(T, mode)
        np.testing.assert_array_equal(ty, jy)
        for k in js:
            np.testing.assert_array_equal(ts[k], js[k])
