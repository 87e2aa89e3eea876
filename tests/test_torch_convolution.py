"""The convolution engine (``ops/conv.py``) and the ``Convolver`` node of
oscen_tpu_torch against the JAX package on the CPU.

Every case of ``tests/test_assets_convolution.py`` that builds a
convolver runs here through both packages with the same seeded inputs.

- ``BlockConvolver.ir_spectra`` is numpy in both packages: bit for bit.
- Everything through an FFT (the engine, the Convolver in block mode with
  ragged blocks, hot swaps, capacity growth and stereo) is held to the JAX
  package at <= 1e-5 max abs: unit-scale uniform noise inputs, IRs of at
  most 256 taps, B=64.  The FFTs differ (pocketfft under numpy and torch,
  XLA's under JAX), so these cannot be equal bit for bit; 1e-5 is 20x
  under the JAX package's own 2e-4 against a naive sum.
- Sample mode against the JAX package's sample mode: <= 1e-5 (the
  per-sample dot's reduction order differs).
- Within the port, a convolver whose crossfade has ended equals a fresh
  one published with the same IR (``torch.equal``), and a steady block
  after the fade runs one rFFT and one irFFT (``ops.conv.launches``).
"""

import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.ops import conv as jconv
from oscen_tpu_torch.ops import conv as tconv
from oscen_tpu_torch.utils.convert import state_from_jax, state_to_numpy

SR = 48000.0
TOL = 1e-5


def _noise(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32)


def _compile(pkg, g, B, mode):
    kw = {"device": "cpu"} if pkg is T else {}
    return g.compile(SR, block_size=B, mode=mode, **kw)


def conv_graph(pkg, ir=None, channels=1, max_ir=256, mode="block", B=64):
    g = pkg.Graph("Conv")
    g.input("x", "stream", channels=channels)
    g.output("out", "stream", channels=channels)
    g.external("ir")
    c = g.add("conv", pkg.Convolver(ir=ir, max_ir_len=max_ir,
                                    channels=channels))
    g.connect("ir", c.ir)
    g.connect("x", c.input)
    g.connect(c.output, "out")
    return _compile(pkg, g, B, mode)


def _both(fn):
    """``fn(pkg)`` for the JAX package and the port, as numpy."""
    return np.asarray(fn(J)), np.asarray(fn(T))


# ------------------------------------------------------------------ #
# ops/conv.py
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("shape", [(100,), (200, 2), (256,), (1,)])
def test_ir_spectra_equal_jax(shape):
    ir = np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32)
    a = jconv.BlockConvolver(64, 256).ir_spectra(ir)
    b = tconv.BlockConvolver(64, 256).ir_spectra(ir)
    assert a.dtype == b.dtype == np.complex64
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("trailing", [(), (2,)])
def test_block_convolver_matches_jax(trailing):
    """The engine alone (tests/test_multirate.py's FDL test): 6 blocks of
    noise through a 200-tap IR against the JAX engine and a naive
    convolution."""
    rng = np.random.default_rng(1)
    ir = rng.uniform(-1, 1, (200,) + trailing).astype(np.float32)
    x = rng.uniform(-1, 1, (6 * 64,) + trailing).astype(np.float32)
    je, te = jconv.BlockConvolver(64, 256), tconv.BlockConvolver(64, 256)
    jh, th = je.ir_spectra(ir), torch.from_numpy(te.ir_spectra(ir))
    js, ts = je.init_state(trailing), te.init_state(trailing)
    ys_j, ys_t = [], []
    for k in range(6):
        xb = x[k * 64:(k + 1) * 64]
        js, yj = je.process_block(js, jh, xb)
        ts, yt = te.process_block(ts, th, torch.from_numpy(xb))
        ys_j.append(np.asarray(yj))
        ys_t.append(yt.numpy())
    a, b = np.concatenate(ys_j), np.concatenate(ys_t)
    np.testing.assert_allclose(b, a, atol=TOL, rtol=0)
    ref = np.stack([np.convolve(x[..., c], ir[..., c])[:len(x)]
                    for c in range(trailing[0])], -1) if trailing \
        else np.convolve(x, ir)[:len(x)]
    np.testing.assert_allclose(b, ref, atol=2e-4)


def test_direct_conv_block_matches_jax():
    rng = np.random.default_rng(2)
    taps = rng.uniform(-1, 1, 9).astype(np.float32)
    hist = np.zeros(8, np.float32)
    x = rng.uniform(-1, 1, 64).astype(np.float32)
    yj, hj = jconv.direct_conv_block(x, hist, taps)
    yt, ht = tconv.direct_conv_block(torch.from_numpy(x),
                                     torch.from_numpy(hist),
                                     torch.from_numpy(taps))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-6)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))


# ------------------------------------------------------------------ #
# the Convolver (tests/test_assets_convolution.py, case by case)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("mode", ["sample", "block"])
def test_convolver_matches_naive(mode):
    ir = _noise(100, seed=1)
    x = _noise(256, seed=2)
    a, b = _both(lambda p: conv_graph(p, ir=ir, max_ir=128, mode=mode)
                 .render_mono(256, stream_inputs={"x": x}))
    np.testing.assert_allclose(b, a, atol=TOL, rtol=0)
    np.testing.assert_allclose(b, np.convolve(x, ir)[:256], atol=2e-4)


def test_convolver_impulse_reproduces_ir():
    ir = _noise(50, seed=3)
    x = np.zeros(128, np.float32)
    x[0] = 1.0
    a, b = _both(lambda p: conv_graph(p, ir=ir, max_ir=64)
                 .render_mono(128, stream_inputs={"x": x}))
    np.testing.assert_allclose(b, a, atol=TOL, rtol=0)
    np.testing.assert_allclose(b[:50], ir, atol=1e-5)
    np.testing.assert_allclose(b[50:], 0.0, atol=1e-5)


def test_convolver_hot_swap_crossfades():
    x = np.ones(4800, np.float32) * 0.5

    def run(pkg):
        c = conv_graph(pkg, ir=[1.0], max_ir=64)
        a = np.asarray(c.render_mono(960, stream_inputs={"x": x}))
        c.publish_asset("ir", pkg.AudioAsset.from_samples(
            np.array([2.0], np.float32), 48000))
        b = np.asarray(c.render_mono(1920, stream_inputs={"x": x}))
        return np.concatenate([a, b])
    ja, ta = _both(run)
    np.testing.assert_allclose(ta, ja, atol=TOL, rtol=0)
    a, b = ta[:960], ta[960:]
    np.testing.assert_allclose(a[100:], 0.5, atol=1e-5)
    assert abs(b[0] - 0.5) < 0.01
    assert abs(b[-1] - 1.0) < 1e-4
    assert np.abs(np.diff(b)).max() < 0.01
    assert abs(b[int(0.02 * 48000) + 5] - 1.0) < 1e-4


def test_convolver_stereo_no_bleed():
    ir_l = _noise(20, seed=4)
    ir_r = _noise(20, seed=5)

    def run(pkg):
        c = conv_graph(pkg, channels=2, max_ir=64)
        c.publish_asset("ir", pkg.AudioAsset.from_samples(
            np.stack([ir_l, ir_r]), 48000))
        c.render(1024, stream_inputs={"x": np.zeros((1024, 2), np.float32)})
        x = np.zeros((128, 2), np.float32)
        x[0, 0] = 1.0
        return c.render(128, stream_inputs={"x": x})["out"]
    a, b = _both(run)
    np.testing.assert_allclose(b, a, atol=TOL, rtol=0)
    np.testing.assert_allclose(b[:20, 0], ir_l, atol=1e-5)
    np.testing.assert_allclose(b[:, 1], 0.0, atol=1e-6)


def test_signal_edge_into_asset_input_rejected():
    g = T.Graph("Bad")
    g.output("out", "stream")
    gn = g.add("g", T.Gain(1.0))
    cv = g.add("c", T.Convolver(max_ir_len=32))
    g.connect(gn.output, "out")
    g.connect(gn.output, cv.ir)
    with pytest.raises(T.GraphError):
        g.lower()


def test_convolver_long_ir_grows_capacity_no_truncation():
    """A 48,000-tap IR into a 1024-tap convolver grows the engine (P 2 ->
    128 at B=512), against the JAX package's growth and the full naive
    convolution."""
    ir = (_noise(48_000, seed=7)
          * np.exp(-np.arange(48_000) / 8000.0)).astype(np.float32)
    x = _noise(4096, seed=8)

    def run(pkg):
        g = pkg.Graph("LongIR")
        g.input("x", "stream")
        g.output("out", "stream")
        g.external("ir")
        c = g.add("conv", pkg.Convolver(max_ir_len=1024))
        g.connect("ir", c.ir)
        g.connect("x", c.input)
        g.connect(c.output, "out")
        comp = _compile(pkg, g, 512, "block")
        comp.publish_asset("ir", pkg.AudioAsset.from_samples(ir, 48000))
        comp.render_mono(int(0.02 * 48000) + 512)
        assert tuple(comp.state["conv"]["fdl"].shape) == (128, 513, 1)
        return comp.render_mono(4096, stream_inputs={"x": x})
    a, b = _both(run)
    ref = np.convolve(x, ir)[:4096]
    err = np.sqrt(np.mean((b - ref) ** 2)) / np.sqrt(np.mean(ref ** 2))
    assert err < 1e-5, err
    # a 48000-tap IR is outside the 256-tap bound: relative to the peak
    assert np.abs(b - a).max() <= TOL * np.abs(a).max()


def test_convolver_steady_state_matches_single_engine():
    """After the crossfade the old engine is skipped: the output equals a
    fresh convolver published with the same IR (torch.equal), and equals
    the JAX package's within 1e-5."""
    ir = _noise(200, seed=9)
    x = _noise(512, seed=10)

    def run(pkg, swaps):
        c = conv_graph(pkg, ir=None, max_ir=256, mode="block")
        for k in range(swaps):
            c.publish_asset("ir", pkg.AudioAsset.from_samples(
                _noise(150, seed=20 + k), 48000))
            c.render_mono(1024)
        c.publish_asset("ir", pkg.AudioAsset.from_samples(ir, 48000))
        c.render_mono(2048)
        return c.render_mono(512, stream_inputs={"x": x})
    a = np.asarray(run(J, 0))
    fresh = run(T, 0)
    swapped = run(T, 2)
    assert torch.equal(torch.from_numpy(swapped), torch.from_numpy(fresh))
    np.testing.assert_allclose(fresh, a, atol=TOL, rtol=0)
    np.testing.assert_allclose(fresh, np.convolve(x, ir)[:512], atol=2e-4)


def test_convolver_swap_within_capacity_keeps_shapes():
    from oscen_tpu_torch.graph.node import tree_map
    c = conv_graph(T, ir=_noise(100, seed=11), max_ir=128, mode="block")
    c.render_mono(256)
    shapes = []
    tree_map(lambda v: shapes.append((tuple(v.shape), v.dtype)), c.state)
    c.publish_asset("ir", T.AudioAsset.from_samples(_noise(120, seed=12),
                                                    48000))
    after = []
    tree_map(lambda v: after.append((tuple(v.shape), v.dtype)), c.state)
    assert after == shapes
    assert c._mirrors == {"conv": {"fade_pos": 0}}
    c.render_mono(256)
    assert c._mirrors == {"conv": {"fade_pos": 256}}


@pytest.mark.parametrize("channels,max_ir", [(1, 64), (2, 256)])
def test_convolver_swaps_growth_and_ragged_blocks_match_jax(channels,
                                                            max_ir):
    """Swaps mid-fade, a growth from 64 to 256 taps, and ragged blocks
    (37, a B=64 tail) in one run, stereo and mono."""
    x = np.random.default_rng(3).uniform(
        -1, 1, (2400, channels)).astype(np.float32)
    if channels == 1:
        x = x[:, 0]

    def run(pkg):
        c = conv_graph(pkg, channels=channels, max_ir=max_ir)
        outs = [c.render(500, stream_inputs={"x": x[:500]})["out"]]
        c.publish_asset("ir", pkg.AudioAsset.from_samples(
            np.stack([_noise(50, 4), _noise(50, 5)]), 48000))
        outs.append(c.render(700, stream_inputs={"x": x[500:1200]})["out"])
        c.publish_asset("ir", pkg.AudioAsset.from_samples(
            _noise(200, 6), 48000))
        outs.append(c.process_block(37, stream_inputs={
            "x": x[1200:1237]})["out"])
        c.publish_asset("ir", pkg.AudioAsset.from_samples(
            _noise(256, 7), 48000))
        outs.append(c.render(1000, stream_inputs={"x": x[1237:2237]},
                             tail=37)["out"])
        return np.concatenate([np.asarray(o) for o in outs])
    a, b = _both(run)
    assert b.shape == a.shape and np.abs(a).max() > 1.0
    np.testing.assert_allclose(b, a, atol=TOL, rtol=0)


@pytest.mark.parametrize("channels", [1, 2])
def test_convolver_sample_mode_matches_jax(channels):
    """Sample mode (the per-sample tick) with a swap mid-run and a growth
    from 64 to 128 taps, against the JAX package's sample mode."""
    x = np.random.default_rng(4).uniform(
        -1, 1, (384, channels)).astype(np.float32)
    if channels == 1:
        x = x[:, 0]

    def run(pkg):
        c = conv_graph(pkg, ir=_noise(40, 1), channels=channels, max_ir=64,
                       mode="sample")
        a = c.render(128, stream_inputs={"x": x[:128]})["out"]
        c.publish_asset("ir", pkg.AudioAsset.from_samples(_noise(100, 2),
                                                          48000))
        b = c.render(256, stream_inputs={"x": x[128:]})["out"]
        return np.concatenate([np.asarray(a), np.asarray(b)])
    a, b = _both(run)
    np.testing.assert_allclose(b, a, atol=TOL, rtol=0)


def test_convolver_array_shares_one_asset():
    """[Convolver; 3] bound to one external: the publish broadcasts the IR
    into every instance (consumed once, the replaced leaves broadcast),
    each instance keeps its own input history."""
    x = np.random.default_rng(5).uniform(-1, 1, (320, 3)).astype(
        np.float32)
    ir = _noise(30, 8)

    def run(pkg):
        g = pkg.Graph("ConvArr")
        for i in range(3):
            g.input(f"x{i}", "stream")
        g.output("out", "stream")
        g.external("ir")
        cv = g.add("cv", pkg.Convolver(max_ir_len=64), count=3)
        g.connect("ir", cv.ir)
        for i in range(3):
            g.connect(f"x{i}", cv[i].input)
        g.connect(cv.output, "out")   # fan-in sum over the instances
        c = _compile(pkg, g, 64, "block")
        a = c.render_mono(64, stream_inputs={
            f"x{i}": x[:64, i] for i in range(3)})
        c.publish_asset("ir", pkg.AudioAsset.from_samples(ir, 48000))
        c.render_mono(960, stream_inputs={f"x{i}": np.zeros(960, np.float32)
                                          for i in range(3)})
        b = c.render_mono(256, stream_inputs={
            f"x{i}": x[64:, i] for i in range(3)})
        return np.concatenate([np.asarray(a), np.asarray(b)])
    a, b = _both(run)
    np.testing.assert_allclose(b, a, atol=TOL, rtol=0)
    np.testing.assert_array_equal(b[:64], 0.0)
    # after the fade, each instance convolves its own channel's input
    # (the 960 silent samples flushed the pre-publish history)
    ref = np.convolve(x[64:].sum(1), ir)[:256]
    np.testing.assert_allclose(b[64:], ref, atol=2e-4)


def test_state_from_jax_carries_the_convolver():
    """A JAX Convolver's state (complex64 fdl / h_cur / h_old, int32
    fade_pos) carried into a port graph mid-fade renders within 1e-5 of
    the JAX graph from there on."""
    x = _noise(640, seed=13)
    jc = conv_graph(J, ir=_noise(60, 1), max_ir=128)
    tc = conv_graph(T, ir=_noise(60, 1), max_ir=128)
    jc.render_mono(128, stream_inputs={"x": x[:128]})
    jc.publish_asset("ir", J.AudioAsset.from_samples(_noise(90, 2), 48000))
    jc.render_mono(128, stream_inputs={"x": x[128:256]})
    import jax
    np_state = jax.tree_util.tree_map(np.asarray, jc.state)
    tc.state = state_from_jax(np_state, device="cpu")
    st = tc.state["conv"]
    assert st["fdl"].dtype == st["h_cur"].dtype == st["h_old"].dtype \
        == torch.complex64
    assert st["fade_pos"].dtype == torch.int32 and int(st["fade_pos"]) == 128
    # the host mirror follows the carried state, as a restore sets it
    tc._mirrors["conv"] = {"fade_pos": int(st["fade_pos"])}
    back = state_to_numpy(tc.state)["conv"]
    for k in ("fdl", "h_cur", "h_old", "fade_pos"):
        np.testing.assert_array_equal(back[k], np_state["conv"][k])
    a = np.asarray(jc.render_mono(384, stream_inputs={"x": x[256:]}))
    b = tc.render_mono(384, stream_inputs={"x": x[256:]})
    np.testing.assert_allclose(b, a, atol=TOL, rtol=0)


def test_post_fade_steady_block_runs_one_irfft():
    """FFT calls per block: 1 rFFT and 2 irFFTs while fading, 1 and 1 once
    the fade has ended (the host mirror picks the branch), 2 rFFTs and 2
    irFFTs per channel set on a ragged block plus the FDL rebuild."""
    c = conv_graph(T, ir=_noise(50, 1), channels=2, max_ir=128)
    x = np.zeros((64, 2), np.float32)
    c.publish_asset("ir", T.AudioAsset.from_samples(_noise(80, 2), 48000))
    counts = []
    for _ in range(17):   # the 960-sample fade ends in block 15
        tconv.reset_launches()
        c.process_block(stream_inputs={"x": x})
        counts.append(dict(tconv.launches))
    fading = {"rfft": 1, "irfft": 2}
    steady = {"rfft": 1, "irfft": 1}
    assert counts[:15] == [fading] * 15
    assert counts[15:] == [steady] * 2
    tconv.reset_launches()
    c.process_block(40, stream_inputs={"x": x[:40]})
    assert tconv.launches == {"rfft": 4, "irfft": 2}
