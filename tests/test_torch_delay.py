"""The delay line on the CPU: ``oscen_tpu_torch/ops/ringbuffer.py`` and
``nodes/delay.py`` against the JAX package, and the port's own invariants.

The port's ``Delay`` has the JAX package's paths: the chunked
``process_block`` and the dissolved-island read and write, both resting on
a ``min_delay`` promise, and the per-sample tick scan everywhere else (no
promise, short chunks, a node array, a scan island).  The JAX package's
per-sample scan (its block fallback, equal to its sample mode) is the
reference each is held to.

Tolerances: ``rb_get`` against eager JAX bit for bit (measured 0), against
``jax.jit`` 1e-6 (XLA contracts the Catmull-Rom products and sums; measured
4.8e-7); the chunked delay against the JAX scan 1e-6, and with the
out-of-range clamp cadence (feedback 1.5 between update frames) 1e-5
absolute and relative — the bounds the JAX package pins for its own
chunked path against its scan (``tests/test_delay_feedback.py:156,277``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.ops import ringbuffer as jrb
from oscen_tpu_torch.ops import ringbuffer as trb

SR = 48000.0


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_rb_get_matches_jax(jit):
    """Random fractional offsets, and offsets within 2e-6 of an integer on
    either side of the 1e-6 snap; write positions past the capacity."""
    rng = np.random.default_rng(0)
    buf = rng.standard_normal(256).astype(np.float32)
    wp = rng.integers(0, 600, 500).astype(np.int32)
    off = rng.uniform(0, 250, 500).astype(np.float32)
    off[:200] = (np.round(off[:200]) + rng.choice(
        [0.0, 5e-7, -5e-7, 2e-6, -2e-6], 200)).astype(np.float32)
    get = jax.jit(jrb.rb_get) if jit else jrb.rb_get
    a = np.asarray(jax.vmap(lambda w, d: get(jnp.asarray(buf), w, d))(
        jnp.asarray(wp), jnp.asarray(off)))
    b = trb.rb_get(torch.tensor(buf), torch.tensor(wp),
                   torch.tensor(off)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-6 if jit else 0.0, rtol=0)
    a = np.asarray(jax.vmap(lambda w, d: jrb.rb_get_linear(
        jnp.asarray(buf), w, d))(jnp.asarray(wp), jnp.asarray(off)))
    b = trb.rb_get_linear(torch.tensor(buf), torch.tensor(wp),
                          torch.tensor(off)).numpy()
    np.testing.assert_array_equal(b, a)


def test_ring_buffer_basics():
    assert [trb.next_power_of_two(n) for n in (0, 1, 5, 64, 88200)] == \
        [jrb.next_power_of_two(n) for n in (0, 1, 5, 64, 88200)]
    buf, wp = trb.rb_new(5)
    assert buf.shape == (8,) and wp.dtype == torch.int32
    for v in range(10):
        buf, wp = trb.rb_push(buf, wp, float(v))
    assert int(wp) == 10 % 8
    assert float(trb.rb_get(buf, wp, torch.tensor(0.0))) == 9.0
    assert float(trb.rb_get(buf, wp, torch.tensor(3.0))) == 6.0


def _delay_graph(pkg, delay, fb, min_delay, params=False):
    g = pkg.Graph("D")
    g.input("x", "stream")
    g.output("out", "stream")
    d = g.add("d", pkg.Delay(delay, 0.0 if params else fb,
                             min_delay=min_delay))
    if params:
        g.input("fb", "value", default=fb)
        g.input("dly", "value", default=delay)
        g.connect("fb", d.feedback)
        g.connect("dly", d.delay_samples)
    g.connect("x", d.input)
    g.connect(d.output, "out")
    return g


def _render(pkg, g, B, n, seed, scale=1.0, **kw):
    x = (np.random.default_rng(seed).standard_normal(n) * scale).astype(
        np.float32)
    c = g.compile(SR, block_size=B, **kw)
    return c.render_mono(n, stream_inputs={"x": x})


@pytest.mark.parametrize("delay,fb,min_delay,B,n,seed", [
    (150.0, 0.6, 64, 256, 1024, 7),    # integer delay, chunk 60
    (77.25, 0.4, 40, 128, 512, 8),     # fractional, chunk 36
], ids=["integer", "fractional"])
def test_chunked_delay_matches_jax_scan(delay, fb, min_delay, B, n, seed):
    """``test_chunked_delay_matches_scan`` / ``_fractional``: the port's
    chunked path against the JAX package's per-sample scan (no promise)
    and its own chunked path."""
    b = _render(T, _delay_graph(T, delay, fb, min_delay), B, n, seed,
                device="cpu")
    a = _render(J, _delay_graph(J, delay, fb, 0), B, n, seed)
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
    a2 = _render(J, _delay_graph(J, delay, fb, min_delay), B, n, seed)
    np.testing.assert_allclose(b, a2, atol=1e-6, rtol=0)
    assert np.abs(b).max() > 1.0


def test_out_of_range_clamp_cadence_matches_jax_scan():
    """``test_out_of_range_params_clamp_cadence_mode_equivalence``: feedback
    1.5 and the delay clamped only on every 32nd frame, raw in between."""
    b = _render(T, _delay_graph(T, 90.0, 1.5, 64, params=True), 256, 1024,
                11, 0.1, device="cpu")
    a = _render(J, _delay_graph(J, 90.0, 1.5, 0, params=True), 256, 1024,
                11, 0.1)
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5)
    assert np.abs(b).max() > 0.3


def test_delay_line_delays():
    """An impulse comes out ``delay + 1`` samples later (read before push),
    with feedback echoes at multiples scaled by feedback^k."""
    c = _delay_graph(T, 16.0, 0.5, 16).compile(SR, block_size=64,
                                                device="cpu")
    x = np.zeros(64, np.float32)
    x[0] = 1.0
    out = c.process_block(stream_inputs={"x": x})["out"].numpy()
    assert np.nonzero(np.abs(out) > 1e-9)[0][0] == 17
    assert out[17] == 1.0 and out[34] == 0.5 and out[51] == 0.25


def test_chunked_delay_block_size_invariance():
    """The chunks follow the block boundaries, the reads do not: bit for
    bit across block sizes (every block at least one chunk long)."""
    runs = [_render(T, _delay_graph(T, 100.0, 0.7, 64), B, 1024, 3,
                    device="cpu") for B in (512, 64, 96)]
    assert torch.equal(torch.tensor(runs[0]), torch.tensor(runs[1]))
    assert torch.equal(torch.tensor(runs[0]), torch.tensor(runs[2]))


def test_literal_read_equals_the_interpolating_read():
    """The dissolved read's contiguous gather (a literal integral delay)
    equals ``rb_get``'s snap branch it replaces, across the ring's wrap."""
    node = T.Delay(1000.0, 0.0, min_delay=1000)
    st = node.init_state(T.SampleRate(SR))
    rng = np.random.default_rng(2)
    st["buf"] = torch.tensor(rng.standard_normal(st["buf"].shape[0]).astype(
        np.float32))
    st["write_pos"] = torch.tensor(st["buf"].shape[0] - 300,
                                   dtype=torch.int32)
    ins = {"delay_samples": torch.full((512,), 1000.0),
           "feedback": torch.zeros(512)}
    lit, _ = node.block_read(st, ins, 512,
                             literal_ins={"delay_samples": 1000.0})
    gen, _ = node.block_read(st, ins, 512)
    assert torch.equal(lit, gen)
    st["write_pos"] = torch.tensor(200, dtype=torch.int32)  # read wraps
    lit, _ = node.block_read(st, ins, 512,
                             literal_ins={"delay_samples": 1000.0})
    assert torch.equal(lit, node.block_read(st, ins, 512)[0])


def test_named_via_delay_dissolves_and_matches_jax():
    """A cycle through a named via Delay whose min_delay >= B + 4
    dissolves: the port against the JAX package's scan island (no promise)
    and its dissolved island."""
    def build(pkg, min_delay):
        g = pkg.Graph("ViaNode")
        g.input("x", "stream")
        g.output("out", "stream")
        mix = g.add("mix", pkg.Gain(1.0))
        echo = g.add("echo", pkg.Delay(300.0, 0.0, min_delay=min_delay))
        g.connect("x", mix.input)
        g.connect(mix.output * 0.5, mix.input, via="echo")
        g.connect(mix.output, "out")
        return g
    b = _render(T, build(T, 300), 256, 1024, 4, device="cpu")
    for min_delay in (0, 300):
        a = _render(J, build(J, min_delay), 256, 1024, 4)
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
    c = build(T, 300).compile(SR, block_size=256, device="cpu")
    assert {"node": "echo", "path": "dissolved_island_delay"} in c.explain()


def test_what_needs_the_per_sample_scan_raises():
    """What the port used to refuse now runs where the JAX package scans
    the per-sample tick, and matches it at 1e-6 (its chunked-path bound):
    no promise, chunks under 8, a block shorter than a chunk (the Delay's
    tick scan), a cycle through a samples via, a promise too short for the
    block and no promise at all on the echo (scan islands).  Nothing
    raises."""
    for md, B in ((0, 64), (10, 64), (64, 32)):
        a = _render(J, _delay_graph(J, 100.0, 0.5, md), B, 256, 4)
        b = _render(T, _delay_graph(T, 100.0, 0.5, md), B, 256, 4,
                    device="cpu")
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
        assert np.abs(b[101:]).max() > 0.1

    def cycle(pkg):
        g = pkg.Graph("FB")
        g.input("x", "stream")
        g.output("out", "stream")
        mix = g.add("mix", pkg.Gain(1.0))
        fb = g.add("fb", pkg.Gain(0.5))
        g.connect("x", mix.input)
        g.connect(mix.output, fb.input)
        g.connect(fb.output, mix.input, via=32)
        g.connect(mix.output, "out")
        return g
    np.testing.assert_allclose(
        _render(T, cycle(T), 256, 512, 5, device="cpu"),
        _render(J, cycle(J), 256, 512, 5), atol=1e-6, rtol=0)

    from oscen_tpu.models.simple import build_simple_echo as jecho
    from oscen_tpu_torch.models.simple import build_simple_echo as techo
    for seconds, md in ((0.001, True), (0.25, False)):
        a = _render(J, jecho(seconds, SR, min_delay=md), 512, 1024, 6, 0.3)
        b = _render(T, techo(seconds, SR, min_delay=md), 512, 1024, 6, 0.3,
                    device="cpu")
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)


def test_delay_node_array_has_no_block_path():
    """A Delay node array has no instance-batched block path: its ticks
    run over the instance axis (one ring per instance), as the JAX package
    ``vmap``s the node, and match it at 1e-6."""
    def build(pkg):
        g = pkg.Graph("DA")
        g.output("out", "stream")
        o = g.add("o", pkg.Oscillator.sine(220.0, 0.5))
        d = g.add("d", pkg.Delay(100.0, 0.3, min_delay=100), count=2)
        g.connect(o.output, d.input)
        g.connect(d.output, "out")
        return g
    a = build(J).compile(SR, block_size=128).render_mono(512)
    c = build(T).compile(SR, block_size=128, device="cpu")
    b = c.render_mono(512)
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
    assert np.abs(b[:101]).max() == 0.0 and np.abs(b[101:]).max() > 0.5
    assert tuple(c.state["d"]["buf"].shape) == (2, 131072)
