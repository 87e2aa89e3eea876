"""Control blocks replayed (``jit=True``, ``oscen_tpu_torch/graph/capture.py``)
on the CPU, where a replay calls the block function on the capture's static
buffers, its packed staging unpacked there: every line of the protocol but
the CUDA capture itself.

- The four bench models with a ``midi_in`` at 8 voices, B=64 and 256: a
  note-off and a note-on every block at offsets that change each block,
  then a ramp of a parameter, then a ``set_value``; ``jit=True`` against
  ``jit=False``, ``torch.equal`` on every output and on the state; the
  repeated event and ramp blocks replay, every eager block is a key's
  warm-up, and a replayed block reads nothing back from the tensors.
- The same event-dense sequence against the JAX package's jitted
  ``CompiledGraph`` at the bounds the slices pin (PERF.md, section 2:
  piano 1e-4, poly synth, fm synth and pivot 1e-5).
- The key: a replay whose event offsets differ from its capture's gives
  the eager answer (the slots are not in the key, and the captured block
  gets none); a scan-island graph keeps its slots in the key; capacities
  1, 2 and 4 are a capture each, reused when they come back.
- A ``VoiceClassHost`` switching classes at replayed event blocks.
"""

import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.models.electric_piano import build_electric_piano as jpiano
from oscen_tpu.models.fm_synth import build_fm_synth as jfm
from oscen_tpu.models.pivot import build_pivot as jpivot
from oscen_tpu.models.poly_synth import build_poly_synth as jpoly
from oscen_tpu_torch import bench
from oscen_tpu_torch.core.types import Kind
from oscen_tpu_torch.graph.capture import tree_sig
from oscen_tpu_torch.graph.node import tree_map
from oscen_tpu_torch.models.electric_piano import build_electric_piano
from oscen_tpu_torch.utils.voice_classes import VoiceClassHost

SR = 48000.0
VOICES = 8
EVENT_BLOCKS = 14

# each model's ramp (a parameter, its target; over 3.5 blocks) and
# set_value
CONTROLS = {
    "electric_piano": (("vibrato_intensity", 0.6), ("brightness", 45.0)),
    "poly_synth": (("resonance", 0.5), ("cutoff", 1800.0)),
    "fm_synth": (("route", 0.5), ("filter_cutoff", 1500.0)),
    "pivot": (("cutoff", 3000.0), ("op3_feedback", 0.3)),
}
JAX_MODELS = {"electric_piano": (jpiano, 1e-4), "poly_synth": (jpoly, 1e-5),
              "fm_synth": (jfm, 1e-5), "pivot": (jpivot, 1e-5)}


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    return tree_sig(a) == tree_sig(b) and all(
        torch.equal(x, y) for x, y in zip(la, lb))


def _out(c):
    return [o.name for o in c.ir.outputs if o.kind != Kind.EVENT][0]


def events(c, pkg, i, B):
    """Block ``i``'s note-off and note-on of one chord key, at offsets that
    change each block (the note-off in the first half of the block, the
    note-on in the second)."""
    key = 36 + i % VOICES
    h = B // 2
    c.queue_event("midi_in", (5 * i + 1) % h,
                  pkg.raw_midi_event([0x80, key, 0]))
    c.queue_event("midi_in", h + (11 * i + 3) % h,
                  pkg.raw_midi_event([0x90, key, 90]))


def _sequence(name, B, jit, counts=None):
    """The chord, EVENT_BLOCKS event blocks, a ramp over 3.5 blocks, then a
    ``set_value`` and two steady blocks; the outputs of every block."""
    graph, voices = bench.build_model(name, VOICES)
    c = graph.compile(SR, block_size=B, device="cpu", jit=jit)
    bench.strike_chord(c, voices)
    outs = [c.process_block()]
    for i in range(EVENT_BLOCKS):
        events(c, T, i, B)
        outs.append(c.process_block())
    if counts is not None:
        counts["events"] = c.block_counts
    (ramp, target), (param, value) = CONTROLS[name]
    c.set_value_with_ramp(ramp, target, 3 * B + B // 2)
    outs += [c.process_block() for _ in range(4)]
    if counts is not None:
        counts["ramp"] = c.block_counts
    c.set_value(param, value)
    outs += [c.process_block() for _ in range(3)]
    return outs, c


def _spy_reads(monkeypatch, seen):
    """Record every read of a tensor's value back to the host."""
    for name in ("item", "__bool__", "nonzero", "tolist"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            seen.append(_name)
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)


@pytest.mark.parametrize("B", [64, 256])
@pytest.mark.parametrize("name", sorted(CONTROLS))
def test_replayed_control_blocks_equal_eager(name, B):
    counts = {}
    a, ca = _sequence(name, B, True, counts)
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
    assert np.abs(a[-1][_out(ca)].numpy()).max() > 0.01
    n = ca.block_counts
    assert n["replayed"] + n["eager"] == cb.block_counts["eager"] == len(a)
    # every eager block is a key's warm-up: the chord, the first event
    # block of each capacity pattern, the first ramp block, the set_value
    # block and the steady key after it
    assert ca.eager_why["warmup"] == n["eager"]
    assert ca.eager_why["jit_off"] == 0 and "sample_mode" not in ca.eager_why
    assert ca.eager_why["sharded"] == ca.eager_why["state_changes_shape"] == 0
    ev, ramp = counts["events"], counts["ramp"]
    assert ev["replayed"] >= EVENT_BLOCKS - 2
    assert ramp["replayed"] - ev["replayed"] >= 3   # the ramp's blocks
    assert n["eager"] <= 8


@pytest.mark.parametrize("name", sorted(CONTROLS))
def test_replayed_event_blocks_read_nothing_back(name, monkeypatch):
    """A replayed event block reads no tensor's value on the host (each
    read would wait for the card there, and a capture refuses it)."""
    graph, voices = bench.build_model(name, VOICES)
    c = graph.compile(SR, block_size=64, device="cpu")
    bench.strike_chord(c, voices)
    c.process_block()
    for i in range(3):
        events(c, T, i, 64)
        c.process_block()
    seen = []
    _spy_reads(monkeypatch, seen)
    before = c.block_counts["replayed"]
    for i in range(3, 6):
        events(c, T, i, 64)
        c.process_block()
    assert c.block_counts["replayed"] == before + 3
    assert seen == []


@pytest.mark.parametrize("name", sorted(JAX_MODELS))
def test_replayed_events_match_jax_jitted(name):
    """The event-dense sequence through replays against the JAX package's
    jitted graph on the same events, at the slice's pinned bound."""
    jbuild, atol = JAX_MODELS[name]
    B = 64
    j = jbuild(VOICES).compile(SR, block_size=B)
    t = bench.build_model(name, VOICES)[0].compile(SR, block_size=B,
                                                   device="cpu")
    out = _out(t)
    for c, pkg in ((j, J), (t, T)):
        for i in range(VOICES):
            c.queue_event("midi_in", 0,
                          pkg.raw_midi_event([0x90, 36 + i, 100]))
    ja, ta = [], []
    for i in range(EVENT_BLOCKS + 1):
        if i:
            events(j, J, i - 1, B)
            events(t, T, i - 1, B)
        ja.append(np.asarray(j.process_block()[out]))
        ta.append(t.process_block()[out].numpy())
    a, b = np.concatenate(ja), np.concatenate(ta)
    assert np.abs(a).max() > 0.01
    np.testing.assert_allclose(b, a, atol=atol, rtol=0)
    assert t.block_counts["replayed"] >= EVENT_BLOCKS - 2


def test_new_offsets_replay_the_eager_answer():
    """The piano's event block captured at one pair of offsets and replayed
    at others: equal to the eager graph on the same events.  Its block
    function reads no slots, so the key has none and the captured block
    gets none."""
    def run(jit):
        p = build_electric_piano(VOICES).compile(SR, block_size=64,
                                                 device="cpu", jit=jit)
        bench.strike_chord(p, VOICES)
        ys = [p.process_block()["out"]]
        for i, (off, on) in enumerate(((3, 40), (3, 40), (10, 20), (60, 1),
                                       (0, 63), (31, 32))):
            key = 36 + i % VOICES
            p.queue_event("midi_in", off, T.raw_midi_event([0x80, key, 0]))
            p.queue_event("midi_in", on, T.raw_midi_event([0x90, key, 90]))
            ys.append(p.process_block()["out"])
        return ys, p
    a, pa = run(True)
    b, _ = run(False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not pa._block_fn(64).reads_slots
    assert pa.block_counts["replayed"] >= 4
    assert all(cap.slots is None for cap in pa._captures.caps.values())


def _island_graph():
    """``tests/test_torch_islands.py``'s envelope into a 2x feedback echo:
    its island (the delay and mix) scans per sample."""
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
    return g


def test_scan_island_keeps_its_slots_in_the_key():
    """A graph with a scan island: an offset pattern seen twice replays, a
    new one warms up eagerly; every block equals the eager graph."""
    B = 64
    pattern = [(5, 0.9), (5, 0.9), (5, 0.9), (17, 0.7), (17, 0.6),
               (40, 0.8), (5, 0.5)]
    x = (np.random.default_rng(6).standard_normal(B * len(pattern)) * 0.3
         ).astype(np.float32)

    def run(jit):
        c = _island_graph().compile(SR, block_size=B, device="cpu", jit=jit)
        ys, counts = [], []
        for i, (off, v) in enumerate(pattern):
            c.queue_event("gate", off, v)
            ys.append(c.process_block(
                stream_inputs={"x": x[i * B:(i + 1) * B]})["out"])
            counts.append(dict(c.block_counts))
        return ys, counts, c
    a, na, ca = run(True)
    b, _, _ = run(False)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert ca._block_fn(B).reads_slots
    # offsets 5: warm-up, capture, replay; 17: warm-up, then a replay (the
    # value is data); 40: warm-up; 5 again: its capture replays
    assert [n["replayed"] for n in na] == [0, 1, 2, 2, 3, 3, 4]
    assert na[-1]["captures"] == 2
    assert ca.eager_why["warmup"] == 3
    assert all(cap.slots for cap in ca._captures.caps.values())


def _env_graph():
    g = T.Graph("Env")
    g.input("gate", "event")
    g.output("out", "stream")
    osc = g.add("osc", T.Oscillator(frequency=330.0))
    env = g.add("env", T.AdsrEnvelope(attack=0.001, decay=0.02,
                                      sustain=0.6, release=0.01))
    vca = g.add("vca", T.Vca())
    g.connect("gate", env.gate)
    g.connect(osc.output, vca.input)
    g.connect(env.output, vca.control)
    g.connect(vca.output, "out")
    return g


def test_event_capacities_are_a_capture_each():
    """Blocks of 1, 2 and 3 gate events (capacities 1, 2 and 4), twice
    round: three captures, then the second round replays them all."""
    def run(jit):
        c = _env_graph().compile(SR, block_size=64, device="cpu", jit=jit)
        ys, caps = [], []
        for rnd in range(2):
            for n in (1, 2, 3):
                for i in range(2 if rnd else 3):
                    for k in range(n):
                        c.queue_event("gate", (7 * i + 19 * k + rnd) % 64,
                                      0.9 if k % 2 == 0 else 0.0)
                    ys.append(c.process_block()["out"])
            caps.append(dict(c.block_counts))
        return ys, caps, c
    a, caps, ca = run(True)
    b, _, _ = run(False)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert caps[0] == {"replayed": 6, "eager": 3, "captures": 3}
    assert caps[1] == {"replayed": 12, "eager": 3, "captures": 3}


def test_voice_class_switches_at_replayed_event_blocks():
    """A class host switching 16 -> 4 -> 16 with events every block: equal
    to the eager host, and event blocks replay in each class."""
    def run(jit):
        vc = VoiceClassHost(build_electric_piano, capacities=(4, 16),
                            sample_rate=SR, block_size=64, tail_seconds=0.01,
                            device="cpu")
        for comp in vc.variants.values():
            comp.jit = jit
        ys, caps = [], []
        for i in range(20):
            if i == 0:
                for j in range(3):
                    vc.queue_event("midi_in", 0,
                                   T.raw_midi_event([0x90, 60 + j, 100]))
            elif i == 2:
                for j in range(3):
                    vc.queue_event("midi_in", 5,
                                   T.raw_midi_event([0x80, 60 + j, 0]))
            elif i == 12:
                for j in range(8):
                    vc.queue_event("midi_in", 9,
                                   T.raw_midi_event([0x90, 50 + j, 100]))
            else:
                # an unheld note-off and a short note every block, at
                # offsets that move
                vc.queue_event("midi_in", (3 * i) % 30,
                               T.raw_midi_event([0x80, 1, 0]))
            ys.append(vc.process_block()["out"])
            caps.append(vc.active_cap)
        return ys, caps, vc
    a, ca, va = run(True)
    b, cb, vb = run(False)
    assert ca == cb and 4 in ca and ca[-1] == 16 and va.switches >= 2
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    for comp in va.variants.values():
        assert comp.eager_why["warmup"] == comp.block_counts["eager"]
    assert sum(c.block_counts["replayed"] for c in va.variants.values()) >= 10


def test_publish_into_a_captured_fade_block():
    """A publish block is a control block too: publishes of IRs of one
    length, each followed by one block (a fade's first, then the third
    publish on replays it), then a few blocks more.  A publish keeps the
    current IR and its spectra as the old ones, so the replayed block's
    new state holds the capture's own static leaves at other places; it
    equals the eager graph block for block."""
    rng = np.random.default_rng(5)
    irs = [(rng.standard_normal(200) * 0.1).astype(np.float32)
           for _ in range(5)]
    x = (rng.standard_normal(64 * 40) * 0.3).astype(np.float32)

    def run(jit):
        g = T.Graph("Conv")
        g.input("x", "stream")
        g.output("out", "stream")
        g.external("ir")
        cv = g.add("conv", T.Convolver(max_ir_len=256))
        g.connect("ir", cv.ir)
        g.connect("x", cv.input)
        g.connect(cv.output, "out")
        c = g.compile(SR, block_size=64, device="cpu", jit=jit)
        ys, pos = [], 0
        for k, ir in enumerate(irs):
            c.publish_asset("ir", T.AudioAsset.from_samples(ir, int(SR)))
            for _ in range(1 if k < len(irs) - 1 else 3):
                ys.append(c.process_block(
                    stream_inputs={"x": x[pos:pos + 64]})["out"])
                pos += 64
        return ys, c
    a, ca = run(True)
    b, _ = run(False)
    assert ca.block_counts["replayed"] >= 2
    assert all(torch.equal(u, v) for u, v in zip(a, b))
