"""Captured blocks (``jit=True``, ``oscen_tpu_torch/graph/capture.py``) on
the CPU, where a replay calls the block function on the capture's static
buffers: every line of the protocol but the CUDA capture itself.

- The eight ``oscen_tpu_torch.bench`` models at 8 voices, B=64 and 256:
  ``jit=True`` against ``jit=False``, ``torch.equal`` on every output and
  on the state, through the chord, steady blocks, a ``set_value``, a ramp,
  an event, a return to steady, a change of block length, and
  ``render_steady`` and ``steady_checksum``; the twin peaks and the echo
  with audio staged every block (effect blocks).
- The Convolver through publish -> fade -> steady, and an IR that grows
  its state; a ``VoiceClassHost`` switching classes.
- The piano, the poly synth and the echo, ``render_steady`` and
  ``steady_checksum`` with replays, against the JAX package's jitted
  ``CompiledGraph`` at the bounds the slices' tests pin (PERF.md, section
  2: piano 1e-4, poly synth 1e-5, echo 1e-6).
- Snapshots: ``state``, ``node_state`` and returned outputs are not
  changed by later blocks; a state of numpy leaves resumes; ``explain()``
  leaves captures, counts and launch counters alone.
- The capture key: a new block length, the first set of a parameter (the
  literals), a ``host_ins`` value, a host mirror, a state shape and the
  additive version each give a new capture, and a key seen before reuses
  its capture.
"""

import math

import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.models.electric_piano import build_electric_piano as jpiano
from oscen_tpu.models.poly_synth import build_poly_synth as jpoly
from oscen_tpu.models.simple import build_simple_echo as jecho
from oscen_tpu_torch import bench
from oscen_tpu_torch.core.types import Kind
from oscen_tpu_torch.graph.capture import CapturedBlock, Staging, tree_sig
from oscen_tpu_torch.graph.node import tree_map
from oscen_tpu_torch.models.electric_piano import build_electric_piano
from oscen_tpu_torch.models.pivot import build_pivot
from oscen_tpu_torch.ops.cuda import launch_counters
from oscen_tpu_torch.utils.voice_classes import VoiceClassHost

SR = 48000.0
VOICES = 8

# each model's parameter changes: (set_value, ramp (name, value, frames))
CHANGES = {
    "electric_piano": (("brightness", 45.0), ("vibrato_speed", 7.0, 100)),
    "poly_synth": (("cutoff", 1800.0), ("resonance", 0.5, 100)),
    "fm_synth": (("filter_cutoff", 1500.0), ("route", 0.5, 100)),
    "pivot": (("op3_feedback", 0.3), ("cutoff", 3000.0, 100)),
    "readme_synth": (None, None),
    "simple_echo": (("feedback", 0.6), ("mix", 0.8, 100)),
    "saturator": (None, None),
    "twin_peaks": (("cutoff_a", 640.0), ("resonance", 0.8, 100)),
}


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    return tree_sig(a) == tree_sig(b) and all(
        torch.equal(x, y) for x, y in zip(la, lb))


def _feeder(c, seed=3):
    """Seeded audio for each stream input, block by block."""
    streams = [gi for gi in c.ir.inputs if gi.kind == Kind.STREAM]
    rng = np.random.default_rng(seed)

    def feed(B):
        if not streams:
            return {}
        return {"stream_inputs": {
            gi.name: (rng.standard_normal(
                (B,) + ((gi.channels,) if gi.channels > 1 else ())) * 0.3
            ).astype(np.float32) for gi in streams}}
    return feed


def _sequence(name, B, jit):
    """The model through every kind of block; every output, the state and
    the graph."""
    graph, voices = bench.build_model(name, VOICES)
    c = graph.compile(SR, block_size=B, device="cpu", jit=jit)
    bench.strike_chord(c, voices)
    feed = _feeder(c)
    outs = []

    def blocks(n, Bn=None):
        for _ in range(n):
            outs.append(c.process_block(Bn, **feed(Bn or B)))
    blocks(4)                       # the chord, then steady
    value, ramp = CHANGES[name]
    if value is not None:
        c.set_value(*value)
        blocks(3)
        c.set_value_with_ramp(*ramp)
        blocks(4)                   # the ramp, then steady again
    if voices > 1:                  # an event, then a new steady key
        c.queue_event("midi_in", 5, T.raw_midi_event([0x80, 36, 0]))
        c.queue_event("midi_in", 9, T.raw_midi_event([0x90, 70, 90]))
        blocks(3)
    blocks(3, B // 2)               # another block length
    blocks(2)
    outs.append(c.render_steady(3))
    outs.append({"ck": torch.tensor(c.steady_checksum(4))})
    blocks(2)
    return outs, c


@pytest.mark.parametrize("B", [64, 256])
@pytest.mark.parametrize("name", sorted(bench.MODELS))
def test_replayed_sequence_equals_eager(name, B):
    a, ca = _sequence(name, B, True)
    b, cb = _sequence(name, B, False)
    assert len(a) == len(b)
    for oa, ob in zip(a, b):
        assert sorted(oa) == sorted(ob)
        for k in oa:
            if isinstance(oa[k], torch.Tensor):
                assert torch.equal(oa[k], ob[k]), k
            else:
                assert oa[k] == ob[k]
    assert _same_state(ca.state, cb.state)
    assert cb.block_counts["replayed"] == 0 == cb.block_counts["captures"]
    assert cb.eager_why["jit_off"] == cb.block_counts["eager"]
    n = ca.block_counts
    assert n["replayed"] + n["eager"] == cb.block_counts["eager"]
    # steady blocks, render_steady and steady_checksum replay
    assert n["replayed"] >= 12 and n["captures"] >= 3
    assert ca.eager_why["state_changes_shape"] == 0
    assert ca.eager_why["jit_off"] == 0


def test_effect_blocks_reuse_the_steady_staging():
    """An echo block whose only fresh input is its audio replays, and its
    staging copies the audio alone."""
    c = bench.build_model("simple_echo")[0].compile(SR, block_size=64,
                                                    device="cpu")
    feed = _feeder(c)
    c.process_block(**feed(64))            # warm-up of the first block's
    #                                        key (its audio packed in)
    c.process_block(**feed(64))            # warm-up, fills the staging
    staged = c._staging_cache[64]
    for _ in range(4):
        c.process_block(**feed(64))
    assert c._staging_cache[64] is staged
    assert c.block_counts == {"replayed": 4, "eager": 2, "captures": 1}
    assert c.eager_why["warmup"] == 2
    # a block without audio replays with zeros in the stream buffer
    y = c.process_block()["out"]
    e = bench.build_model("simple_echo")[0].compile(SR, block_size=64,
                                                    device="cpu", jit=False)
    feed = _feeder(e)
    for _ in range(6):
        e.process_block(**feed(64))
    assert torch.equal(e.process_block()["out"], y)


def _conv(ir_len, cap, jit, B=64):
    g = T.Graph("Conv")
    g.input("x", "stream")
    g.output("out", "stream")
    g.external("ir")
    cv = g.add("conv", T.Convolver(max_ir_len=cap))
    g.connect("ir", cv.ir)
    g.connect("x", cv.input)
    g.connect(cv.output, "out")
    c = g.compile(SR, block_size=B, device="cpu", jit=jit)
    return c


def test_convolver_publish_fade_steady_and_growth():
    """Each fade block has a key of its own (the host mirror) and runs
    eagerly; the steady block after the fade is captured; an IR longer
    than the capacity grows the state (its shapes, a new key), and the
    steady block after its fade is a new capture."""
    rng = np.random.default_rng(4)
    ir1 = (rng.standard_normal(200) * 0.1).astype(np.float32)
    ir2 = (rng.standard_normal(700) * 0.1).astype(np.float32)
    x = (rng.standard_normal(64 * 60) * 0.3).astype(np.float32)

    def run(jit):
        c = _conv(200, 256, jit)
        ys, counts = [], []
        pos = 0

        def blocks(n):
            nonlocal pos
            for _ in range(n):
                ys.append(c.process_block(
                    stream_inputs={"x": x[pos:pos + 64]})["out"])
                pos += 64
                counts.append(dict(c.block_counts))
        c.publish_asset("ir", T.AudioAsset.from_samples(ir1, int(SR)))
        blocks(20)        # 15 fade blocks (960 samples), then steady
        c.publish_asset("ir", T.AudioAsset.from_samples(ir2, int(SR)))
        blocks(20)        # a grown state, its fade, steady
        return ys, counts, c
    a, na, ca = run(True)
    b, _, cb = run(False)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert _same_state(ca.state, cb.state)
    assert tuple(ca.state["conv"]["fdl"].shape)[0] > 4   # grown
    # the publish block and 14 more fade blocks (one key each, the host
    # mirror) and the first steady block warm up, the rest replay
    assert na[15]["replayed"] == 0
    assert na[16]["captures"] == 1 and na[19]["replayed"] == 4
    assert na[39]["captures"] == 2 and na[39]["replayed"] == 8
    assert ca.eager_why["warmup"] == 2 * 16


def test_voice_class_switches_replay_no_stale_capture():
    """A class host switching 16 -> 4 -> 16: each variant keeps its own
    captures, and a switch back never replays a stale one."""
    def run(jit):
        vc = VoiceClassHost(build_electric_piano, capacities=(4, 16),
                            sample_rate=SR, block_size=64, tail_seconds=0.01,
                            device="cpu")
        for comp in vc.variants.values():
            comp.jit = jit
        ys, caps = [], []
        for i in range(14):
            if i == 0:
                for j in range(3):
                    vc.queue_event("midi_in", 0,
                                   T.raw_midi_event([0x90, 60 + j, 100]))
            if i == 2:
                for j in range(3):
                    vc.queue_event("midi_in", 0,
                                   T.raw_midi_event([0x80, 60 + j, 0]))
            if 3 <= i < 8:   # unheld note-offs run the allocator's clock
                vc.queue_event("midi_in", 0, T.raw_midi_event([0x80, 1, 0]))
            if i == 8:
                for j in range(8):
                    vc.queue_event("midi_in", 0,
                                   T.raw_midi_event([0x90, 50 + j, 100]))
            ys.append(vc.process_block()["out"])
            caps.append(vc.active_cap)
        return ys, caps, vc
    a, ca, va = run(True)
    b, cb, vb = run(False)
    assert ca == cb and 4 in ca and ca[-1] == 16 and va.switches >= 2
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert sum(c.block_counts["replayed"] for c in va.variants.values()) > 0


# ------------------------------------------------------------------ #
# against the JAX package's jitted CompiledGraph
# ------------------------------------------------------------------ #
def _chord(c, pkg, voices):
    for i in range(voices):
        c.queue_event("midi_in", 0,
                      pkg.raw_midi_event([0x90, 36 + (i % 64), 100]))


@pytest.mark.parametrize("name, jbuild, tbuild, atol", [
    ("piano", lambda: jpiano(4), lambda: build_electric_piano(4), 1e-4),
    ("poly", lambda: jpoly(4), lambda: bench.build_model("poly_synth", 4)[0],
     1e-5),
    ("echo", jecho, lambda: bench.build_model("simple_echo")[0], 1e-6),
])
def test_replays_match_jax_jitted(name, jbuild, tbuild, atol):
    B = 64
    j = jbuild().compile(SR, block_size=B)
    t = tbuild().compile(SR, block_size=B, device="cpu")
    x = (np.random.default_rng(9).standard_normal(4 * B) * 0.3
         ).astype(np.float32)
    out = [o.name for o in t.ir.outputs if o.kind != Kind.EVENT][0]
    ja, ta = [], []
    for k in range(4):
        if name == "echo":
            si = {"stream_inputs": {"x": x[k * B:(k + 1) * B]}}
        else:
            si = {}
            if k == 0:
                _chord(j, J, 4)
                _chord(t, T, 4)
        ja.append(np.asarray(j.process_block(**si)[out]))
        ta.append(t.process_block(**si)[out].numpy())
    rj, rt = j.render_steady(5), t.render_steady(5)
    ja.append(np.asarray(rj[out]))
    ta.append(rt[out].numpy())
    a, b = np.concatenate(ja), np.concatenate(ta)
    assert np.abs(a).max() > 0.01
    np.testing.assert_allclose(b, a, atol=atol, rtol=0)
    ck_j, ck_t = j.steady_checksum(3), t.steady_checksum(3)
    n = 3 * B * (a.shape[1] if a.ndim > 1 else 1)
    assert abs(ck_t - ck_j) <= 2 * atol * math.sqrt(n * ck_j) + n * atol ** 2
    assert t.block_counts["replayed"] >= 8


# ------------------------------------------------------------------ #
# snapshots, setters, explain
# ------------------------------------------------------------------ #
def _piano(jit=True, B=64):
    p = build_electric_piano(VOICES).compile(SR, block_size=B, device="cpu",
                                             jit=jit)
    for i in range(4):
        p.queue_event("midi_in", 0, T.raw_midi_event([0x90, 50 + 5 * i,
                                                      100]))
    return p


def test_state_node_state_and_outputs_are_snapshots():
    p = _piano()
    outs = [p.process_block()["out"] for _ in range(4)]
    kept = [o.clone() for o in outs]
    s = p.state
    s_copy = tree_map(torch.clone, s)
    v = p.node_state("voices")
    v_copy = tree_map(torch.clone, v)
    outs += [p.process_block()["out"] for _ in range(4)]
    p.render_steady(2)
    p.steady_checksum(2)
    assert all(torch.equal(a, b) for a, b in zip(outs, kept))
    assert _same_state(s, s_copy) and _same_state(v, v_copy)
    assert not _same_state(p.state, s)   # the graph moved on


def test_numpy_leaf_state_resumes_replayed_blocks():
    """A state of numpy leaves set between replayed blocks: the next block
    replays from it, equal to the eager graph given the same."""
    def run(jit):
        p = _piano(jit)
        for _ in range(4):
            p.process_block()
        saved = tree_map(lambda x: x.numpy().copy(), p.state)
        first = [p.process_block()["out"] for _ in range(3)]
        p.state = saved
        again = [p.process_block()["out"] for _ in range(3)]
        return first, again, p
    fa, aa, pa = run(True)
    fb, ab, _ = run(False)
    assert all(torch.equal(x, y) for x, y in zip(fa, aa))
    assert all(torch.equal(x, y) for x, y in zip(fa + aa, fb + ab))
    assert pa.block_counts["replayed"] >= 5


def test_explain_leaves_captures_and_counts_alone():
    p = _piano()
    for _ in range(4):
        p.process_block()
    caps = dict(p._captures.caps)
    counts = p.block_counts
    launches = [dict(c) for c in launch_counters()]
    state = p.state
    notes = p.explain()
    assert notes
    assert p._captures.caps == caps and p.block_counts == counts
    assert [dict(c) for c in launch_counters()] == launches
    assert _same_state(p.state, state)
    y = p.process_block()["out"]
    assert p.block_counts["replayed"] == counts["replayed"] + 1
    q = _piano(False)
    for _ in range(4):
        q.process_block()
    assert torch.equal(q.process_block()["out"], y)


def test_init_drops_the_captures():
    p = _piano()
    for _ in range(4):
        p.process_block()
    assert p._captures.caps
    p.init()
    assert not p._captures.caps
    assert p.block_counts["captures"] == 1


# ------------------------------------------------------------------ #
# the capture key: each host read gives a new capture
# ------------------------------------------------------------------ #
def _steady(c, n=3, B=None):
    for _ in range(n):
        c.process_block(B)


def test_block_length_gives_a_new_capture():
    p = _piano()
    _steady(p, 4)
    assert p.block_counts["captures"] == 1
    _steady(p, 3, 32)
    assert p.block_counts["captures"] == 2
    _steady(p, 2)          # back to 64: the first capture replays
    assert p.block_counts["captures"] == 2


def test_literal_parameters_give_a_new_capture():
    p = _piano()
    _steady(p, 4)
    p.set_value("brightness", 30.0)   # its default: only the literals move
    _steady(p, 3)
    assert p.block_counts["captures"] == 2
    assert len({k[0] for k in p._captures.caps}) == 2


def test_host_ins_value_gives_a_new_capture():
    """The pivot's op3_feedback feeds host_ins (the zero-feedback branch):
    0.3 and back to 0.0 are two keys; the second 0.0 reuses its capture."""
    def run(jit):
        c = build_pivot(VOICES).compile(SR, block_size=64, device="cpu",
                                        jit=jit)
        bench.strike_chord(c, VOICES)
        ys, caps = [], []
        for v in (None, 0.3, 0.0, 0.3):
            if v is not None:
                c.set_value("op3_feedback", v)
            for _ in range(4):
                ys.append(c.process_block()["audio_out"])
            caps.append(c.block_counts["captures"])
        return ys, caps
    a, caps = run(True)
    b, _ = run(False)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    # the first set drops the literal; 0.3 and 0.0 then share the block
    # function and differ by host_ins alone
    assert caps == [1, 2, 3, 3]


def test_host_mirror_gives_a_new_key():
    c = _conv(200, 256, True)
    rng = np.random.default_rng(2)
    c.publish_asset("ir", T.AudioAsset.from_samples(
        (rng.standard_normal(100) * 0.1).astype(np.float32), int(SR)))
    keys = set()
    for _ in range(16):
        keys.add(c._block_fn(64).host_key({}))
        c.process_block(stream_inputs={"x": np.ones(64, np.float32)})
    # fade positions 0, 64, ..., 896 and the steady 960
    assert len(keys) == 16


def test_additive_version_gives_a_new_capture(monkeypatch):
    def run(jit):
        monkeypatch.setenv("OSCEN_ADDITIVE_KERNEL", "v4")
        p = _piano(jit)
        ys = [p.process_block()["out"] for _ in range(4)]
        monkeypatch.setenv("OSCEN_ADDITIVE_KERNEL", "parity")
        ys += [p.process_block()["out"] for _ in range(4)]
        return ys, p
    a, pa = run(True)
    b, _ = run(False)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert pa.block_counts["captures"] == 2


def test_captured_block_writes_its_state_back_in_place():
    """The protocol itself: a state leaf the block returns unchanged stays
    the static buffer, a new leaf is copied into it, an output viewing a
    static leaf is copied before the write-back."""
    st = {"a": torch.zeros(3), "b": torch.ones(2)}

    def fn(state, per_block, ev_bufs):
        return ({"a": state["a"] + per_block["x"], "b": state["b"]},
                {"y": state["a"]})
    def staged(x):
        return Staging({("pb", "x"): np.full(3, x, np.float32)},
                       torch.device("cpu"))
    cap = CapturedBlock(fn, torch.device("cpu"), st, staged(1.0))
    a0 = cap.state["a"]
    y1 = cap.replay()["y"].clone()
    y2 = cap.replay()["y"]
    assert cap.state["a"] is a0 and torch.equal(a0, torch.full((3,), 2.0))
    assert torch.equal(y1, torch.zeros(3)) and torch.equal(y2, torch.ones(3))
    assert torch.equal(st["a"], torch.zeros(3))   # the input is untouched
    cap.load(st, staged(5.0))
    cap.replay()
    assert torch.equal(cap.state["a"], torch.full((3,), 5.0))
