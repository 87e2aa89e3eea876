"""The echo and saturator slice end to end on the CPU: ``build_simple_echo``,
``build_saturator`` and the IIR-boundary saturator through
oscen_tpu_torch against the JAX package's compiled graphs, and the
multirate and feedback machinery's own invariants.

Inputs are seeded numpy noise (x 0.3) through the echo's ``x`` stream.  The
IIR-boundary saturator is built through the public ``Graph`` API as
``tools/monobench.py:46-53`` builds it (``policy="sinc_iir"``).

Tolerance against JAX: 1e-6 (measured 6e-8 on the echo, 1.8e-7 on every
saturator, over 2048-4096 samples; the target is the IIR graph's 2e-6).
The differences come from XLA contracting products and sums into FMAs in
the compiled graph and from its float32 ``tanh`` (the port rounds ``tanh``
once from float64).  Inside the port, block-size invariance is bit for bit
(``torch.equal``) for every resampler policy and for the dissolved echo.
"""

import jax
import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.models import simple as jsimple
from oscen_tpu_torch.core.types import stream
from oscen_tpu_torch.models import simple as tsimple
from oscen_tpu_torch.utils.convert import state_from_jax, state_to_numpy

SR = 48000.0
TOL = 1e-6
X = (np.random.default_rng(3).standard_normal(4096) * 0.3).astype(np.float32)


def _simple(pkg):
    return jsimple if pkg is J else tsimple


def _compile(pkg, g, B, sr=SR):
    if pkg is T:
        return g.compile(sr, block_size=B, device="cpu")
    return g.compile(sr, block_size=B)


def _echo(pkg, min_delay=True, B=512):
    c = _compile(pkg, _simple(pkg).build_simple_echo(0.02, SR,
                                                     min_delay=min_delay), B)
    c.set_value("feedback", 0.6)
    return c


def _sat_policy(pkg, policy, factor=4, freq=2000.0):
    """The saturator with any boundary policy (``sinc_iir``: the
    ``sat4_iir`` graph of tools/monobench.py)."""
    g = pkg.Graph(f"Sat{factor}{policy}")
    g.output("audio_out", "stream")
    osc = g.add("osc", pkg.PolyBlepOscillator.saw(freq, 0.6), rate=factor)
    clip = g.add("clip", pkg.HardClip(), rate=factor)
    g.connect(osc.output, clip.input)
    g.connect(clip.output, "audio_out", policy=policy)
    return g


# ------------------------------------------------------------------ #
# against the JAX package
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("jax_min_delay", [True, False],
                         ids=["jax_dissolved", "jax_scan_island"])
def test_echo_matches_jax(jax_min_delay):
    """``test_echo_island_dissolution_matches_scan``: feedback 0.6, B=512,
    4096 samples; the port's dissolved island against the JAX package's
    dissolved island and its per-sample scan island."""
    a = _echo(J, jax_min_delay).render_mono(4096, stream_inputs={"x": X})
    b = _echo(T).render_mono(4096, stream_inputs={"x": X})
    assert b.shape == a.shape == (4096,)
    assert np.abs(a).max() > 0.3
    np.testing.assert_allclose(b, a, atol=TOL, rtol=0)


@pytest.mark.parametrize("factor", [1, 2, 4, 8])
def test_saturator_matches_jax(factor):
    a = jsimple.build_saturator(factor).compile(SR, block_size=256) \
        .render_mono(2048)
    b = _compile(T, tsimple.build_saturator(factor), 256).render_mono(2048)
    assert np.abs(a).max() > 0.5
    np.testing.assert_allclose(b, a, atol=TOL, rtol=0)


@pytest.mark.parametrize("factor", [2, 4])
def test_iir_saturator_matches_jax(factor):
    a = _sat_policy(J, "sinc_iir", factor).compile(SR, block_size=256) \
        .render_mono(2048)
    c = _compile(T, _sat_policy(T, "sinc_iir", factor), 256)
    b = c.render_mono(2048)
    assert np.abs(a).max() > 0.5
    np.testing.assert_allclose(b, a, atol=TOL, rtol=0)
    notes = [e for e in c.explain() if "resampler" in e]
    assert notes == [{"node": "__output_tap_audio_out", "edge": 1,
                      "input": "input", "resampler": "IirHalfbandDown",
                      "factor": factor}]


def test_latency_matches_jax():
    for factor in (1, 2, 4, 8):
        for policy in ("sinc", "sinc_iir", "linear", "latch"):
            a = _sat_policy(J, policy, factor).compile(SR, 64)
            b = _compile(T, _sat_policy(T, policy, factor), 64)
            assert b.latency_samples() == a.latency_samples()
    assert _compile(T, tsimple.build_saturator(4), 64).latency_samples() == 8


def test_events_rescale_into_an_oversampled_region():
    """``test_event_offsets_rescale_into_oversampled_region``: a gate at
    outer sample 40 into a 2x envelope fires at inner tick 80, the same
    outer time; the latch brings it back."""
    def build(pkg):
        g = pkg.Graph("EvR")
        g.input("gate", "event")
        g.output("out", "stream")
        env = g.add("env", pkg.AdsrEnvelope(0.0, 0.5, 1.0, 0.1), rate=2)
        g.connect("gate", env.gate)
        g.connect(env.output, "out", policy="latch")
        return g
    outs = []
    for pkg in (J, T):
        c = _compile(pkg, build(pkg), 128)
        c.queue_event("gate", 40, 1.0)
        outs.append(np.asarray(c.process_block()["out"]))
    a, b = outs
    assert np.all(b[:40] == 0.0) and b[40] > 0.9
    np.testing.assert_allclose(b, a, atol=TOL, rtol=0)


def test_value_edge_takes_the_latch():
    """``test_multirate_value_edge_latch``: a value input into a 2x node
    is zero-order held; the 100 Hz sine comes out at 100 Hz."""
    def build(pkg):
        g = pkg.Graph("VL")
        g.input("freq", "value", default=100.0)
        g.output("out", "stream")
        osc = g.add("osc", pkg.PolyBlepOscillator.sine(100.0, 1.0), rate=2)
        g.connect("freq", osc.frequency)
        g.connect(osc.output, "out", policy="sinc")
        return g
    c = _compile(T, build(T), 256)
    out = c.render_mono(2048)
    assert c.prog.resamplers[0].__class__.__name__ == "LatchUp"
    spec = np.abs(np.fft.rfft(out[512:] * np.hanning(1536)))
    assert abs(np.fft.rfftfreq(1536, 1 / SR)[spec.argmax()] - 100.0) < 40.0
    a = _compile(J, build(J), 256).render_mono(2048)
    np.testing.assert_allclose(out, a, atol=TOL, rtol=0)


def test_oversampled_node_arrays_fan_in_across_the_boundary():
    """``test_oversampled_node_arrays``: 4 saws and 4 clips at 2x, summed
    into a base-rate gain through the sinc down edge (the resampler runs
    on the summed stream), with a live gain parameter."""
    def build(pkg):
        g = pkg.Graph("OVA")
        g.input("drive", "value", default=1.0)
        g.output("out", "stream")
        oscs = g.add("oscs", pkg.PolyBlepOscillator.saw(500.0, 0.4),
                     count=4, rate=2)
        clips = g.add("clips", pkg.HardClip(), count=4, rate=2)
        mix = g.add("mix", pkg.Gain(0.25))
        g.connect(oscs.output, clips.input)
        g.connect(clips.output, mix.input, policy="sinc")
        g.connect("drive", mix.gain)
        g.connect(mix.output, "out")
        return g
    outs = []
    for pkg in (J, T):
        c = _compile(pkg, build(pkg), 128)
        y = [c.render_mono(256)]
        c.set_value("drive", 0.5)
        y.append(c.render_mono(256))
        outs.append(np.concatenate(y))
    a, b = outs
    assert np.abs(b[200:]).max() > 0.05
    np.testing.assert_allclose(b, a, atol=TOL, rtol=0)


def test_node_array_edge_carries_the_instance_axis_last():
    """A cross-rate edge into a node array resamples each instance: the
    instance axis rides last through the resampler and the state."""
    def build(pkg):
        g = pkg.Graph("UpArr")
        g.input("x", "stream")
        g.output("out", "stream")
        clips = g.add("clips", pkg.HardClip(), count=3, rate=4)
        mix = g.add("mix", pkg.Gain(1.0))
        g.connect("x", clips.input)
        g.connect(clips.output, mix.input, policy="sinc")
        g.connect(mix.output, "out")
        return g
    outs = []
    for pkg in (J, T):
        c = _compile(pkg, build(pkg), 128)
        outs.append(c.render_mono(512, stream_inputs={"x": X[:512]}))
        shapes = [np.shape(v) for v in jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, c.state["__rs__"])
            if pkg is J else state_to_numpy(c.state["__rs__"]))]
        assert (11, 3) in shapes
    np.testing.assert_allclose(outs[1], outs[0], atol=TOL, rtol=0)


def test_hardclip_4x_less_aliasing_than_1x():
    """``test_hardclip_4x_less_aliasing_than_1x`` at 44.1 kHz (the folded
    harmonics of 2 kHz land off its harmonic comb)."""
    sr, f0 = 44_100.0, 2000.0
    out = {f: _compile(T, tsimple.build_saturator(f), 512, sr)
           .render_mono(8192)[4096:] for f in (1, 4)}

    def alias_energy(x):
        spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
        freqs = np.fft.rfftfreq(len(x), 1 / sr)
        harm = np.abs((freqs + f0 / 2) % f0 - f0 / 2) < 80.0
        return spec[~harm & (freqs > 500)].sum()
    assert alias_energy(out[4]) < 0.5 * alias_energy(out[1])


# ------------------------------------------------------------------ #
# the port's own invariants
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("policy", ["sinc", "sinc_iir", "linear", "latch"])
def test_multirate_boundary_invariance(policy):
    """``test_multirate_boundary_invariance``: B=512 against B=128, bit for
    bit, for every resampler family at the boundary."""
    runs = [_compile(T, _sat_policy(T, policy, freq=500.0), B)
            .render_mono(2048) for B in (512, 128)]
    assert torch.equal(torch.tensor(runs[0]), torch.tensor(runs[1]))
    assert np.abs(runs[0]).max() > 0.5


def test_echo_block_size_invariance():
    runs = [_echo(T, B=B).render_mono(4096, stream_inputs={"x": X})
            for B in (512, 128)]
    assert torch.equal(torch.tensor(runs[0]), torch.tensor(runs[1]))


def test_echo_explain_shows_the_dissolved_delay():
    c = _echo(T)
    notes = c.explain()
    assert {"node": "delay", "path": "dissolved_island_delay"} in notes
    assert {"node": "filter", "path": "block"} in notes
    assert "delay: path=dissolved_island_delay" in c.explain(formatted=True)


@pytest.mark.parametrize("model", ["echo", "sat_sinc", "sat_iir"])
def test_jax_state_carries_into_the_port(model):
    """Two blocks in the JAX package, the state carried into the port
    (``__fb__``, ``__rs__`` tuples, the delay's int32 positions), two more
    blocks in each: the port continues the JAX run.  The state maps back
    with the JAX package's tree structure."""
    def build(pkg):
        if model == "echo":
            return _echo(pkg)
        if model == "sat_sinc":
            return _compile(pkg, _simple(pkg).build_saturator(4), 512)
        return _compile(pkg, _sat_policy(pkg, "sinc_iir"), 512)

    def block(c, i):
        si = {"x": X[i * 512:(i + 1) * 512]} if model == "echo" else None
        return np.asarray(c.process_block(stream_inputs=si)[
            "out" if model == "echo" else "audio_out"])

    cj = build(J)
    for i in range(2):
        block(cj, i)
    np_state = jax.tree_util.tree_map(np.asarray, cj.state)
    ct = build(T)
    ct.state = state_from_jax(np_state, device="cpu")
    if model == "echo":
        assert ct.state["delay"]["write_pos"].dtype == torch.int32
        assert set(ct.state["__fb__"]) == {"filter.output"}
    else:
        assert isinstance(ct.state["__rs__"]["1"], tuple)
    a = np.concatenate([block(cj, i) for i in (2, 3)])
    b = np.concatenate([block(ct, i) for i in (2, 3)])
    np.testing.assert_allclose(b, a, atol=TOL, rtol=0)
    back = state_to_numpy(ct.state)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(np_state)
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(np_state)):
        assert x.dtype == y.dtype and x.shape == y.shape


class _Probe(T.Node):
    """A node-array stand-in whose batched path can fuse its fan-in
    mix-down, recording the ``fanin_eps`` the compiler grants it."""

    BATCHED = True
    INPUTS = (stream("input", 0.0),)
    OUTPUTS = (stream("output"),)
    seen: list = []

    def process_block(self, state, ins, events, sr, block_len):
        return state, {"output": ins["input"] * 0.5}

    def process_block_batched(self, state, ins, events, sr, block_len,
                              fanin_eps=frozenset()):
        type(self).seen.append(fanin_eps)
        st, outs = self.process_block(state, ins, events, sr, block_len)
        if "output" in fanin_eps:
            outs["__fanin__output"] = outs["output"].sum(dim=0)
        return st, outs


def test_fanin_fusion_skips_feedback_carries_and_islands():
    """A node array whose output reaches a delay only through a feedback
    fan-in edge, inside a dissolved island: its mix-down must not be fused
    (the fused sum would skip the one-sample shift).  The same array
    feeding a plain fan-in is fused."""
    g = T.Graph("Fb")
    g.input("x", "stream")
    g.output("out", "stream")
    p = g.add("p", _Probe(), count=4)
    d = g.add("d", T.Delay(300.0, 0.0, min_delay=300))
    g.connect("x", p.input)
    g.connect(d.output, p.input)
    g.connect(p.output, d.input, feedback=True)
    g.connect(d.output, "out")
    c = g.compile(SR, block_size=128, device="cpu")
    _Probe.seen = []
    y = c.render_mono(1024, stream_inputs={"x": X[:1024]})
    assert set(_Probe.seen) == {frozenset()}
    assert "p.output" in c.state["__fb__"]
    # by hand: the delay pushes the mix-down of the previous sample
    buf, out, prev = np.zeros(1024, np.float32), [], np.float32(0.0)
    for t in range(1024):
        dl = buf[t - 301] if t >= 301 else np.float32(0.0)
        pv = (X[t] + dl) * np.float32(0.5)
        buf[t] = prev
        prev = pv + pv + pv + pv
        out.append(dl)
    np.testing.assert_allclose(y, np.array(out, np.float32), atol=1e-6,
                               rtol=0)
    assert np.abs(y).max() > 0.5

    g = T.Graph("Mix")
    g.input("x", "stream")
    g.output("out", "stream")
    p = g.add("p", _Probe(), count=4)
    m = g.add("m", T.Gain(1.0))
    g.connect("x", p.input)
    g.connect(p.output, m.input)
    g.connect(m.output, "out")
    _Probe.seen = []
    y = g.compile(SR, block_size=128, device="cpu").render_mono(
        256, stream_inputs={"x": X[:256]})
    assert set(_Probe.seen) == {frozenset({"output"})}
    np.testing.assert_allclose(y, 2.0 * X[:256], atol=1e-6, rtol=0)
