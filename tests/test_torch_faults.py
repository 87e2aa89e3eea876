"""Faults of the port against the JAX package, each pinned here:

1. ``Node.default_inputs()`` exists on every node class the port exports
   and equals the JAX package's in values and shapes;
2. ``Graph.compile`` and ``CompiledGraph`` take ``jit=`` (and ignore it);
3. a state whose leaves are numpy arrays resumes bit for bit, as in
   ``tests/test_models_aux.py::test_checkpoint_restore``;
4. an oscillator's literal frequency is divided by the rate as XLA folds
   it (the saw of ``examples/oversampled_saturator.py`` at 44.1 kHz), in
   block mode and in sample mode;
5. the pivot's operator chain rounds as XLA compiles the JAX pivot tick
   (its products into sums fused): the demo's chords no longer drift;
6. checked, not a fault: the fm synth's operators, ``FmOperator`` (the
   unfused voice, K14's plain version) and the fused chain, do not drift
   from the JAX package's compiled graph over the fm demo's phrase.
"""

import importlib
import inspect

import jax
import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.models.simple import build_simple_synth as jbuild_synth
from oscen_tpu_torch.graph.compile import CompiledGraph
from oscen_tpu_torch.graph.node import Node, tree_map
from oscen_tpu_torch.models.simple import build_simple_synth as tbuild_synth

SR = 48000.0

# constructor arguments where a class has no defaults, and more than one
# input layout (channels, sections)
ARGS = {
    "AdsrBank": [([("op3", 0.01, 0.1, 0.7, 0.3), ("flt", 0.02, 0.2, 0.5,
                                                    0.4)],)],
    "VoiceAllocator": [(4,)],
    "Convolver": [(), (None, 4096, 2)],
    "SamplePlayer": [(), (2,)],
    "TptFilter": [(), (1000.0, 0.707, 2)],
}


def _node_classes():
    return [(name, cls) for name in T.__all__
            for cls in [getattr(T, name)]
            if inspect.isclass(cls) and issubclass(cls, Node)]


def _jax_class(cls):
    """The JAX package's class of the same module path and name."""
    mod = importlib.import_module(
        cls.__module__.replace("oscen_tpu_torch", "oscen_tpu", 1))
    return getattr(mod, cls.__name__)


@pytest.mark.parametrize("name,cls", _node_classes(),
                         ids=[n for n, _ in _node_classes()])
def test_default_inputs_match_jax(name, cls):
    jcls = _jax_class(cls)
    for args in ARGS.get(name, [()]):
        got = cls(*args).default_inputs()
        want = jcls(*args).default_inputs()
        assert sorted(got) == sorted(want), (name, args)
        for k, w in want.items():
            w = np.asarray(w)
            g = got[k]
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
            assert g.dtype == torch.float32 and w.dtype == np.float32
            assert tuple(g.shape) == w.shape, (name, k)
            np.testing.assert_array_equal(g.numpy(), w)


def test_default_inputs_cover_every_node_class():
    """All 31 node classes (and the two bases) are checked above."""
    assert len(_node_classes()) >= 31


def test_jit_keyword_is_accepted_and_ignored():
    """``jit`` is accepted as in the JAX package, and the output ignores
    it: ``jit=True`` replays captured blocks (graph/capture.py), which
    equal the eager blocks of ``jit=False`` bit for bit."""
    a = tbuild_synth().compile(SR, block_size=256, device="cpu")
    b = tbuild_synth().compile(SR, block_size=256, jit=False, device="cpu")
    c = CompiledGraph(tbuild_synth().lower(), SR, 256, mode="block",
                      jit=False, device="cpu")
    ya = a.render_mono(768)
    np.testing.assert_array_equal(b.render_mono(768), ya)
    np.testing.assert_array_equal(c.render_mono(768), ya)


def test_numpy_leaf_state_resumes_bit_exactly():
    """The JAX test's numpy form: the port resumes bit for bit from a
    state of numpy leaves, and matches the JAX package within 1e-4."""
    c = tbuild_synth().compile(SR, block_size=256, device="cpu")
    c.render_mono(512)
    saved = tree_map(lambda x: x.numpy().copy(), c.state)
    a = c.render_mono(512)
    c.state = saved
    assert all(isinstance(x, torch.Tensor) for x in _leaves(c.state))
    b = c.render_mono(512)
    np.testing.assert_array_equal(a, b)
    # dtypes survive: int and bool leaves keep theirs, floats are float32
    for x, y in zip(_leaves(c.state), _leaves(saved)):
        assert x.dtype == torch.from_numpy(np.asarray(y)).dtype

    j = jbuild_synth().compile(SR, block_size=256)
    j.render_mono(512)
    jsaved = jax.tree_util.tree_map(np.asarray, j.state)
    ja = j.render_mono(512)
    j.state = jax.tree_util.tree_map(lambda x: x, jsaved)
    jb = j.render_mono(512)
    np.testing.assert_array_equal(ja, jb)
    np.testing.assert_allclose(b, jb, atol=1e-4, rtol=0)


def test_jax_numpy_state_runs_in_the_port():
    """A JAX state mapped to numpy goes straight into the port's setter
    (no ``state_from_jax``) and continues like the JAX graph."""
    j = jbuild_synth().compile(SR, block_size=256)
    j.render_mono(512)
    c = tbuild_synth().compile(SR, block_size=256, device="cpu")
    c.state = jax.tree_util.tree_map(np.asarray, j.state)
    np.testing.assert_allclose(c.render_mono(512), j.render_mono(512),
                               atol=1e-4, rtol=0)


def test_state_setter_casts_float64_and_keeps_tensors():
    c = tbuild_synth().compile(SR, block_size=256, device="cpu")
    st = tree_map(
        lambda x: (x.numpy().astype(np.float64) if x.is_floating_point()
                   else x), c.state)
    c.state = st
    for x in _leaves(c.state):
        assert not x.is_floating_point() or x.dtype == torch.float32
    kept = c.state
    c.state = kept
    assert all(x is y for x, y in zip(_leaves(c.state), _leaves(kept)))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("connected,mode",
                         [(False, "block"), (True, "block"),
                          (False, "sample")],
                         ids=["literal", "parameter", "literal_sample_mode"])
def test_literal_frequency_increment_folds_like_xla(connected, mode):
    """A saw at 2 kHz and 44.1 kHz, its frequency a node default (XLA
    folds 2000 / 44100 with a true division) or a never-set graph
    parameter (a runtime operand: the reciprocal product): block mode
    matches JAX at 1e-6 over 8820 samples either way (it drifted 5.8e-3
    with the reciprocal on a literal), and so does sample mode with the
    literal, where the ticks take ``folded_ins`` (it drifted 1.2e-3 after
    2048 samples while they did not)."""
    def build(pkg):
        g = pkg.Graph("Saw")
        g.output("o", "stream")
        if connected:
            g.input("f", "value", default=2000.0)
        osc = g.add("osc", pkg.PolyBlepOscillator.saw(2000.0, 0.6))
        if connected:
            g.connect("f", osc.frequency)
        g.connect(osc.output, "o")
        return g
    a = np.asarray(build(J).compile(44100.0, block_size=512, mode=mode)
                   .render_mono(8820))
    b = build(T).compile(44100.0, block_size=512, mode=mode, device="cpu") \
        .render_mono(8820)
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["block", "sample"])
def test_pivot_chords_match_jax_without_feedback(mode):
    """The pivot demo's chords and route ramp at ``op3_feedback`` 0 over
    0.2 s (9600 samples): the port within the fm synth's 1e-5 of JAX in
    both modes.  With the phase step rounded separately it drifted 3.3e-6
    a block, to 6.6e-5: XLA computes the JAX pivot tick's
    ``p + f*ratio/sr`` as one fused multiply-add."""
    from oscen_tpu.models.pivot import build_pivot as jpivot
    from oscen_tpu_torch.examples import pivot_demo as ex
    from oscen_tpu_torch.examples import to_numpy
    from oscen_tpu_torch.models.pivot import build_pivot as tpivot

    def render(synth, raw_midi):
        synth.set_value("filter_env_amount", 1500.0)
        synth.set_value("op3_feedback", 0.0)
        return to_numpy(ex.play(
            synth, raw_midi,
            ex.note_schedule(ex.CHORDS, ex.GATE_SECONDS, ex.SR),
            int(ex.SR * 0.2), ex.BLOCK, "audio_out",
            on_block=ex.pivot_route))
    a = render(jpivot(8).compile(ex.SR, block_size=ex.BLOCK, mode=mode),
               J.raw_midi_event)
    b = render(tpivot(8).compile(ex.SR, block_size=ex.BLOCK, mode=mode,
                                 device="cpu"), T.raw_midi_event)
    assert np.abs(a).max() > 0.1
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_fm_synth_demo_matches_jax(fused):
    """The fm synth demo's first note over 0.3 s (14400 samples, the route
    and cutoff sliders moved every block): the port within the fm synth's
    1e-5 of JAX, with the unfused voice's ``FmOperator`` nodes too.  It
    reads 1.3e-7 at most, with no growth over the blocks: XLA contracts no
    product into a sum in the JAX fm operator that the port rounds apart
    (the pivot's case drifted 3.3e-6 a block)."""
    from oscen_tpu.models.fm_synth import build_fm_synth as jfm
    from oscen_tpu_torch.examples import fm_synth_demo as ex
    from oscen_tpu_torch.examples import to_numpy
    from oscen_tpu_torch.models.fm_synth import build_fm_synth as tfm

    seconds = 0.3
    a = to_numpy(ex.render(
        jfm(8, fused=fused).compile(ex.SR, block_size=ex.BLOCK), seconds,
        J.raw_midi_event))
    b = to_numpy(ex.render(
        tfm(8, fused=fused).compile(ex.SR, block_size=ex.BLOCK,
                                    device="cpu"), seconds,
        T.raw_midi_event))
    assert a.shape == b.shape == (int(ex.SR * seconds),)
    assert np.abs(a).max() > 0.1
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
