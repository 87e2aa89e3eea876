"""The block compiler's per-sample scan islands and the Delay's per-sample
path in oscen_tpu_torch on the CPU: the counterparts of
``tests/test_delay_feedback.py:139-178`` and ``:220-250`` (the chunked
delay against the tick scan, the echo's dissolved island against its scan
island) and ``tests/test_multirate.py:265-376`` (node arrays and feedback
islands inside an oversampled region, with events), at the JAX package's
bounds, plus node arrays without a batched block path against the JAX
package's ``vmap``.
"""

import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu_torch.models.simple import build_simple_echo

SR = 48000.0


def _c(g, B, mode="block"):
    return g.compile(SR, block_size=B, mode=mode, device="cpu")


def _paths(c):
    """Each node's path in ``explain()``."""
    return {e["node"]: e["path"] for e in c.explain() if "path" in e}


def _delay_graph(delay, fb, min_delay):
    g = T.Graph("CD")
    g.input("x", "stream")
    g.output("out", "stream")
    d = g.add("d", T.Delay(delay, fb, min_delay=min_delay))
    g.connect("x", d.input)
    g.connect(d.output, "out")
    return g


def test_chunked_delay_matches_scan():
    """``min_delay=64`` takes the chunked block path (chunks of 60); it
    equals sample mode at 1e-6, and the promise-free block path (the tick
    scan) equals it bit for bit."""
    x = np.random.default_rng(7).standard_normal(1024).astype(np.float32)

    def run(mode, md):
        return _c(_delay_graph(150.0, 0.6, md), 256, mode).render_mono(
            1024, stream_inputs={"x": x})
    a = run("sample", 0)
    np.testing.assert_allclose(a, run("block", 64), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(a, run("block", 0))


def test_chunked_delay_fractional():
    x = np.random.default_rng(8).standard_normal(512).astype(np.float32)

    def run(mode, md):
        return _c(_delay_graph(77.25, 0.4, md), 128, mode).render_mono(
            512, stream_inputs={"x": x})
    np.testing.assert_allclose(run("sample", 0), run("block", 40),
                               atol=1e-6, rtol=0)


def test_echo_island_dissolution_matches_scan():
    """The echo's feedback island dissolves with the promise and runs as a
    scan island without it: atol 1e-6 over 4096 samples at feedback 0.6;
    a delay too short for its promise at this block length scans too."""
    x = (np.random.default_rng(3).standard_normal(4096) * 0.3).astype(
        np.float32)

    def run(min_delay, seconds=0.02, n=4096):
        c = _c(build_simple_echo(seconds, SR, min_delay=min_delay), 512)
        c.set_value("feedback", 0.6)
        return c, c.render_mono(n, stream_inputs={"x": x[:n]})
    (cs, a), (cd, b) = run(False), run(True)
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert np.abs(a).max() > 0.05
    paths = _paths(cs)
    assert paths["delay"] == paths["filter"] == "scan_island"
    assert _paths(cd)["delay"] == "dissolved_island_delay"
    c, out = run(True, seconds=0.001, n=1024)   # 48 samples < B + 4
    assert np.isfinite(out).all() and np.abs(out).max() > 0.05
    assert _paths(c)["delay"] == "scan_island"


def _ova(pkg, drive=True):
    g = pkg.Graph("OVA")
    if drive:
        g.input("drive", "value", default=1.0)
    g.output("out", "stream")
    oscs = g.add("oscs", pkg.PolyBlepOscillator.saw(500.0, 0.4), count=4,
                 rate=2)
    clips = g.add("clips", pkg.HardClip(), count=4, rate=2)
    mix = g.add("mix", pkg.Gain(0.25))
    g.connect(oscs.output, clips.input)
    g.connect(clips.output, mix.input, policy="sinc")  # 4->1 fan-in, down
    if drive:
        g.connect("drive", mix.gain)
    g.connect(mix.output, "out")
    return g


@pytest.mark.parametrize("mode", ["sample", "block"])
def test_oversampled_node_arrays(mode):
    out = _c(_ova(T), 128, mode).render_mono(512)
    assert np.all(np.isfinite(out))
    assert np.abs(out[200:]).max() > 0.05


def test_oversampled_arrays_modes_agree():
    a = _c(_ova(T, drive=False), 128, "sample").render_mono(512)
    b = _c(_ova(T, drive=False), 128, "block").render_mono(512)
    assert np.sqrt(np.mean((a - b) ** 2)) < 1e-3


def _sat_echo(B, mode):
    g = T.Graph("SatEcho2x")
    g.input("x", "stream")
    g.output("out", "stream")
    mix = g.add("mix", T.Mixer(), rate=2)
    clip = g.add("clip", T.HardClip(), rate=2)
    d = g.add("d", T.Delay(97.0, 0.45), rate=2)
    g.connect("x", mix.input_a, policy="sinc")
    g.connect(mix.output, clip.input)
    g.connect(clip.output, d.input)
    g.connect(d.output, mix.input_b, feedback=True)
    g.connect(clip.output, "out", policy="sinc")
    c = _c(g, B, mode)
    x = (np.random.default_rng(5).standard_normal(512) * 0.4).astype(
        np.float32)
    return c, c.render_mono(512, stream_inputs={"x": x})


def test_oversampled_feedback_island_block_mode():
    """A cycle inside a 2x region scans at the inner rate in block mode and
    matches sample mode (atol 1e-6); the island is block-size invariant
    bit for bit."""
    _, a = _sat_echo(128, "sample")
    cb, b = _sat_echo(128, "block")
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert np.abs(a).max() > 0.01
    np.testing.assert_array_equal(b, _sat_echo(64, "block")[1])
    assert _paths(cb)["d"] == "scan_island"


def test_oversampled_feedback_island_with_events():
    """Mid-block events into an oversampled island land on the inner
    timeline (offsets scaled on the host): atol 1e-6 against sample
    mode."""
    def run(mode):
        g = T.Graph("EnvEcho2x")
        g.input("x", "stream")
        g.input("gate", "event")
        g.output("out", "stream")
        env = g.add("env", T.AdsrEnvelope(attack=0.002, decay=0.05,
                                          sustain=0.5, release=0.1), rate=2)
        vca = g.add("vca", T.Vca(), rate=2)
        d = g.add("d", T.Delay(61.0, 0.4), rate=2)
        mix = g.add("mix", T.Mixer(), rate=2)
        g.connect("x", vca.input, policy="sinc")
        g.connect("gate", env.gate)
        g.connect(env.output, vca.control)
        g.connect(vca.output, mix.input_a)
        g.connect(mix.output, d.input)
        g.connect(d.output, mix.input_b, feedback=True)
        g.connect(mix.output, "out", policy="sinc")
        c = _c(g, 128, mode)
        x = (np.random.default_rng(6).standard_normal(384) * 0.3).astype(
            np.float32)
        c.queue_event("gate", 37, 0.9)
        return np.concatenate([c.process_block(
            stream_inputs={"x": x[i * 128:(i + 1) * 128]})["out"].numpy()
            for i in range(3)])
    a, b = run("sample"), run("block")
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert np.abs(a).max() > 0.001


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
def test_island_spanning_a_rate_boundary_raises(pkg):
    """A cycle that crosses into a 2x region and back (mixer -> up ->
    clip -> down -> delay -> feedback -> mixer) is refused in block mode by
    both packages (the reference restricts cross-rate feedback); sample
    mode runs it."""
    kw = {"device": "cpu"} if pkg is T else {}
    g = pkg.Graph("Span")
    g.input("x", "stream")
    g.output("out", "stream")
    mix = g.add("mix", pkg.Mixer())
    clip = g.add("clip", pkg.HardClip(), rate=2)
    d = g.add("d", pkg.Delay(10.0, 0.0))
    g.connect("x", mix.input_a)
    g.connect(mix.output, clip.input, policy="sinc")
    g.connect(clip.output, d.input, policy="sinc")
    g.connect(d.output, mix.input_b, feedback=True)
    g.connect(mix.output, "out")
    x = np.ones(64, np.float32) * 0.5
    with pytest.raises(NotImplementedError, match="rate boundary"):
        g.compile(SR, block_size=64, mode="block", **kw).process_block(
            stream_inputs={"x": x})
    out = g.compile(SR, block_size=64, mode="sample", **kw).process_block(
        stream_inputs={"x": x})["out"]
    assert np.isfinite(np.asarray(out.cpu() if pkg is T else out)).all()


def _delay_array(pkg, count, md):
    g = pkg.Graph("DA")
    g.input("x", "stream")
    g.output("out", "stream")
    d = g.add("d", pkg.Delay(37.5, 0.5, min_delay=md), count=count)
    g.connect("x", d.input)
    g.connect(d.output, "out")
    return g


@pytest.mark.parametrize("md", [0, 64], ids=["no_promise", "promise"])
def test_delay_array_matches_jax(md):
    """A Delay node array (two rings, ``[2, cap]``) in block mode ticks
    over the instance axis, the JAX package's ``vmap``; against JAX at
    1e-6, and its rings stay apart (each instance equals a single delay).
    """
    x = np.random.default_rng(9).standard_normal(512).astype(np.float32)
    a = _delay_array(J, 2, md).compile(SR, block_size=128).render_mono(
        512, stream_inputs={"x": x})
    c = _c(_delay_array(T, 2, md), 128)
    b = c.render_mono(512, stream_inputs={"x": x})
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
    one = _c(_delay_array(T, 1, md), 128).render_mono(
        512, stream_inputs={"x": x})
    np.testing.assert_allclose(b, 2 * one, atol=1e-6, rtol=0)
    assert c.state["d"]["buf"].shape[0] == 2
    assert {"node": "d", "path": "vmap"} in c.explain()


def test_scan_island_reads_the_card_nowhere(monkeypatch):
    """A scan island and sample mode read no tensor back to the host: no
    ``.item()``, ``bool()`` or ``nonzero`` inside a block (each would wait
    for the card there)."""
    seen = []
    for name in ("item", "__bool__", "nonzero", "tolist"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            seen.append(_name)
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)
    x = (np.random.default_rng(1).standard_normal(256) * 0.3).astype(
        np.float32)
    for mode in ("block", "sample"):
        c = _c(build_simple_echo(0.002, SR, min_delay=False), 128, mode)
        c.set_value("feedback", 0.5)
        c.process_block(stream_inputs={"x": x[:128]})
        seen.clear()
        c.process_block(stream_inputs={"x": x[128:]})
        assert seen == [], (mode, seen)
