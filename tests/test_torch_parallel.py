"""Voice sharding in the port (``oscen_tpu_torch/parallel/voices.py``) on
the CPU: gloo ranks against the port unsharded and against the JAX package
sharded and unsharded.

Mirrors every test of ``tests/test_multichip.py`` under its name, at its
sizes, for 2 and 8 ranks.  The ranks are ``torch.multiprocessing.spawn``
processes that run ``tests/torch_parallel_ranks.py`` (the port only, no
JAX) through a ``FileStore``: one spawn per world size renders every case,
and the tests read what each rank saved.  The JAX package runs here, on the
conftest's 8 virtual CPU devices (``voice_mesh(n)``, the first n), without
interpret mode: its sharded renders run its plain paths under
``shard_map``, as the port's ranks run their plain versions (the kernels on
the card).  The four cases that are slow in the JAX package (interpret-mode
Pallas kernels) are not slow here.

Tolerances (absolute): the JAX tests' own for the port against the JAX
package sharded and unsharded, 2e-6 for the poly synth and the scalar
envelope, 2e-5 for the fm synth, 5e-4 for the piano (the port's v4 closed
forms against the JAX package's composed voice on the CPU), 1e-5 with rtol
1e-6 for the feedback island (the all-reduce re-associates the mix-down);
the port sharded against the port unsharded at the same bounds, the
piano's 1e-4.  Every rank returns the same all-reduced mix, bit for bit,
and stages the same bytes each block.
"""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.parallel.voices import shard_compiled_state as jshard
from oscen_tpu.parallel.voices import voice_mesh as jmesh
from torch_parallel_ranks import (CHORD8, CHORD16, SR, poly_render, run,
                                  scalar_env_graph, voice_echo_graph)

WORLDS = (2, 8)


@pytest.fixture(scope="module", params=WORLDS, ids=[f"world{w}"
                                                    for w in WORLDS])
def ranks(request, tmp_path_factory):
    """(world size, each rank's results) from one spawn of every case."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"ranks{world}")
    mp.spawn(run, args=(world, str(tmp)), nprocs=world, join=True)
    return world, [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                   for r in range(world)]


def _case(ranks, name):
    """A case's results on every rank; their outputs are bit-equal."""
    world, results = ranks
    per_rank = [r[name] for r in results]
    if "out" in per_rank[0]:
        for r in per_rank[1:]:
            np.testing.assert_array_equal(r["out"], per_rank[0]["out"])
    return world, per_rank


_UNSHARDED = {}


def _once(key, fn):
    """``fn()``, computed once for both world sizes (the unsharded
    references)."""
    if key not in _UNSHARDED:
        _UNSHARDED[key] = fn()
    return _UNSHARDED[key]


def _jax_pair(key, world, *args):
    """The JAX package's render unsharded and sharded over ``world``."""
    return [_once(("jax", key), lambda: _jax_render(*args)),
            _jax_render(*args, world)]


def _jax_render(build, B, mode, events, blocks, out, world=None):
    """The JAX package's render, sharded over ``world`` devices or not."""
    c = build().compile(SR, block_size=B, mode=mode)
    if world:
        jshard(c, jmesh(world))
    for ep, off, payload in events:
        c.queue_event(ep, off, payload)
    return np.concatenate([np.asarray(c.process_block()[out])
                           for _ in range(blocks)])


def _midi(pkg, notes, spacing):
    return [("midi_in", i * spacing, pkg.raw_midi_event([0x90, n, 100]))
            for i, n in enumerate(notes)]


def _port_render(build, B, mode, events, blocks, out):
    c = build().compile(SR, block_size=B, mode=mode, device="cpu")
    for ep, off, payload in events:
        c.queue_event(ep, off, payload)
    return np.concatenate([c.process_block()[out].numpy()
                           for _ in range(blocks)])


def _check(got, port, jax_pair, atol, port_atol=None, rtol=0.0):
    """``got`` (a rank's sharded render) against the port unsharded and
    the JAX package unsharded and sharded."""
    np.testing.assert_allclose(got, port, atol=port_atol or atol, rtol=rtol)
    for want in jax_pair:
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("mode", ["sample", "block"])
def test_sharded_render_matches_unsharded(ranks, mode):
    world, res = _case(ranks, f"render_{mode}")
    assert len(jax.devices()) >= world, "conftest should provide 8 devices"
    got = res[0]["out"]
    from oscen_tpu.models.poly_synth import build_poly_synth as jpoly
    jev = _midi(J, CHORD8, 3)
    jax_pair = _jax_pair(f"poly8_{mode}", world, lambda: jpoly(8), 128, mode,
                         jev, 3, "audio_out")
    port = _once(f"poly8_{mode}", lambda: poly_render(
        8, 128, mode, CHORD8, 3, 3, shard=False)[1])
    _check(got, port, jax_pair, 2e-6)
    if mode == "sample":
        # the per-sample step runs on the gathered state: bit for bit
        np.testing.assert_array_equal(got, port)
    assert np.abs(got).max() > 0.01


@pytest.mark.parametrize("model", ["piano", "poly"])
def test_sharded_replays_equal_eager(ranks, model):
    """Sharded blocks with ``jit=True`` on gloo ranks on the CPU: after each
    key's warm-up they replay (the stand-in of a captured block: the block
    function, all-reduces included, on the capture's static buffers), equal
    bit for bit to ``jit=False``; none is eager as ``sharded``; and the
    render stays within this file's bounds of the port unsharded (piano
    1e-4, poly synth 2e-6)."""
    from torch_parallel_ranks import replay_render
    world, res = _case(ranks, f"replay_{model}")
    for r in res:
        np.testing.assert_array_equal(r["out"], r["eager"])
        assert r["backend"] == "gloo"
        assert r["why"]["sharded"] == r["why"]["jit_off"] == 0
        assert r["why"]["warmup"] == r["counts"]["eager"]
        # the chord, the steady key, the ramp and the steady key after it
        # (the ramped parameter no longer literal) warm up; the rest replay
        assert r["counts"]["eager"] == 4 and r["counts"]["replayed"] == 5
    want = _once(f"replay_{model}",
                 lambda: replay_render(model, shard=False)[0])
    np.testing.assert_allclose(res[0]["out"], want,
                               atol={"piano": 1e-4, "poly": 2e-6}[model],
                               rtol=0)
    assert np.abs(want).max() > 0.01


@pytest.mark.parametrize("jit,device,backend,why", [
    (True, "cuda", "gloo", "sharded"),
    (True, "cuda", "nccl", None),
    (True, "cuda", "cpu:gloo,cuda:nccl", None),
    (True, "cpu", "gloo", None),
    (True, "cuda", None, None),
    (True, "cpu", None, None),
    (False, "cuda", "nccl", "jit_off"),
    (False, "cpu", "gloo", "jit_off"),
])
def test_sharded_capture_decision(jit, device, backend, why):
    """What ``CompiledGraph._run_block`` asks before a block: a sharded
    block on a card whose group does not run NCCL for CUDA tensors stays
    eager (``sharded``: gloo waits for the card on the host); an NCCL
    group, or any group on the CPU (no CUDA graph there), is captured."""
    from oscen_tpu_torch.graph.capture import eager_reason
    assert eager_reason(jit, torch.device(device), backend) == why


def test_sharded_state_placement(ranks):
    world, res = _case(ranks, "placement")
    for r in res:
        assert r["type"] == "DTensor" and r["shard0"]
        assert r["global"] == (8,) and r["local"] == (8 // world,)
        assert r["arrays"] == ["Shard"]
        assert set(r["rest"]) <= {"Replicate"}
        assert np.isfinite(r["out"]).all()
        # the setter: DTensors back in, bit for bit; a full state sliced
        np.testing.assert_array_equal(*r["roundtrip"])
        np.testing.assert_allclose(*r["from_full"], atol=2e-6, rtol=0)


def test_sharded_block_mode_runs_pallas_kernels(ranks):
    """32 voices: each rank runs the batched block path (the kernels on
    the card, their plain versions here) on its slice, the fused mix-down
    all-reduced."""
    world, res = _case(ranks, "poly32")
    from oscen_tpu.models.poly_synth import build_poly_synth as jpoly
    jev = _midi(J, CHORD8[:4], 5)
    jax_pair = _jax_pair("poly32", world, lambda: jpoly(32), 64, "block", jev,
                         3, "audio_out")
    port = _once("poly32", lambda: poly_render(
        32, 64, "block", CHORD8[:4], 5, 3, shard=False)[1])
    _check(res[0]["out"], port, jax_pair, 2e-6)
    assert np.abs(port).max() > 0.01


def test_sharded_electric_piano_fanin_fusion(ranks):
    world, res = _case(ranks, "piano16")
    from oscen_tpu.models.electric_piano import build_electric_piano as jep
    from oscen_tpu_torch.models.electric_piano import build_electric_piano
    jev = [("midi_in", 0, J.raw_midi_event([0x90, 48 + i * 3, 100]))
           for i in range(8)]
    tev = [("midi_in", 0, T.raw_midi_event([0x90, 48 + i * 3, 100]))
           for i in range(8)]
    jax_pair = _jax_pair("piano16", world, lambda: jep(16), 64, "block", jev,
                         3, "out")
    port = _once("piano16", lambda: _port_render(
        lambda: build_electric_piano(16), 64, "block", tev, 3, "out"))
    _check(res[0]["out"], port, jax_pair, 5e-4, port_atol=1e-4)
    assert np.abs(port).max() > 0.001


def test_sharded_requires_divisible_voice_count(ranks):
    world, res = _case(ranks, "divisible")
    for r in res:
        assert r["error"] is not None and "divisible" in r["error"]
    if world == 8:   # the JAX package's case: 6 voices on 8 devices
        from oscen_tpu.models.poly_synth import build_poly_synth as jpoly
        s = jpoly(6).compile(SR, block_size=64, mode="block")
        jshard(s, jmesh(8))
        s.queue_event("midi_in", 0, J.raw_midi_event([0x90, 60, 100]))
        with pytest.raises(ValueError, match="divisible"):
            s.process_block()


def test_sharded_fm_synth(ranks):
    world, res = _case(ranks, "fm16")
    from oscen_tpu.models.fm_synth import build_fm_synth as jfm
    from oscen_tpu_torch.models.fm_synth import build_fm_synth
    notes = (48, 55, 60, 64)
    jev = [("midi_in", 0, J.raw_midi_event([0x90, n, 100])) for n in notes]
    tev = [("midi_in", 0, T.raw_midi_event([0x90, n, 100])) for n in notes]
    jax_pair = _jax_pair("fm16", world, lambda: jfm(16), 64, "block", jev, 3,
                         "audio_out")
    port = _once("fm16", lambda: _port_render(
        lambda: build_fm_synth(16), 64, "block", tev, 3, "audio_out"))
    _check(res[0]["out"], port, jax_pair, 2e-5)
    assert np.abs(port).max() > 1e-3


def test_sharded_steady_render(ranks):
    """``render_steady`` and ``steady_checksum`` on the sharded staging:
    every rank holds the full span, equal to the unsharded port's."""
    world, res = _case(ranks, "steady")
    from oscen_tpu_torch.models.poly_synth import build_poly_synth
    c = build_poly_synth(16).compile(SR, block_size=64, device="cpu")
    for n in (48, 55, 60, 64):
        c.queue_event("midi_in", 0, T.raw_midi_event([0x90, n, 100]))
    c.process_block()
    want = c.render_steady(4)["audio_out"].numpy()
    want_ck = c.steady_checksum(4)
    for r in res:
        a = r["out"]
        assert a.shape == (4 * 64,)
        assert np.isfinite(a).all() and np.abs(a).max() > 0.01
        np.testing.assert_allclose(a, want, atol=2e-6, rtol=0)
        assert np.isfinite(r["checksum"]) and r["checksum"] > 0.0
        assert r["checksum"] == pytest.approx(want_ck, rel=1e-5)
        assert r["checksum"] == res[0]["checksum"]


def test_scalar_node_event_buffer_replicates(ranks):
    """8 gate events round the scalar envelope's buffer capacity to 8, the
    oscillator array's count: every rank keeps the whole buffer and sees
    every event."""
    world, res = _case(ranks, "scalar_events")
    for r in res:
        assert r["env_buffer"][0] == (8,)
    jev = [("gate_in", i * 7, 0.5 + 0.05 * i) for i in range(8)]
    from oscen_tpu.graph.builder import Graph as JGraph
    from oscen_tpu.nodes.basic import Vca as JVca
    from oscen_tpu.nodes.envelope import AdsrEnvelope as JAdsr
    from oscen_tpu.nodes.oscillators import Oscillator as JOsc

    def jbuild():
        g = JGraph("ScalarEnvVoices")
        g.input("gate_in", "event")
        g.output("audio_out", "stream")
        oscs = g.add("oscs", JOsc(frequency=220.0), count=8)
        env = g.add("env", JAdsr(attack=0.001, decay=0.05, sustain=0.6,
                                 release=0.1))
        vca = g.add("vca", JVca())
        g.connect("gate_in", env.gate)
        g.connect(oscs.output, vca.input)
        g.connect(env.output, vca.control)
        g.connect(vca.output, "audio_out")
        return g
    jax_pair = _jax_pair("scalar_env", world, jbuild, 64, "block", jev, 3,
                         "audio_out")
    port = _once("scalar_env", lambda: _port_render(
        scalar_env_graph, 64, "block", jev, 3, "audio_out"))
    _check(res[0]["out"], port, jax_pair, 2e-6)
    assert np.abs(port).max() > 0.01


def test_sharded_voice_feedback_island(ranks):
    """16 per-voice feedback cycles scan as an island on each rank's
    slice; the island's fan-in all-reduces once per sample and the final
    mix-down once per block."""
    world, res = _case(ranks, "island")
    from oscen_tpu.graph.builder import Graph as JGraph
    from oscen_tpu.nodes.basic import Mixer
    from oscen_tpu.nodes.delay import Delay
    from oscen_tpu.nodes.midi import MidiParser, MidiVoiceHandler
    from oscen_tpu.nodes.oscillators import Oscillator
    from oscen_tpu.nodes.voice_allocator import VoiceAllocator

    def jbuild():
        g = JGraph("VoiceEcho")
        g.input("midi_in", "event")
        g.output("audio_out", "stream")
        parser = g.add("parser", MidiParser())
        alloc = g.add("alloc", VoiceAllocator(16))
        handlers = g.add("handlers", MidiVoiceHandler(), count=16)
        oscs = g.add("oscs", Oscillator(frequency=220.0), count=16)
        mix = g.add("mix", Mixer(), count=16)
        d = g.add("d", Delay(50.0, 0.0), count=16)
        g.connect("midi_in", parser.midi_in)
        g.connect(parser.note_on, alloc.note_on)
        g.connect(parser.note_off, alloc.note_off)
        g.connect(alloc.voices, handlers.note_on)
        g.connect(handlers.frequency, oscs.frequency)
        g.connect(oscs.output, mix.input_a)
        g.connect(mix.output, d.input)
        g.connect(d.output, mix.input_b, feedback=True)
        g.connect(d.output, "audio_out")
        return g
    jev = [("midi_in", i % 5, J.raw_midi_event([0x90, n, 100]))
           for i, n in enumerate(CHORD16)]
    tev = [("midi_in", i % 5, T.raw_midi_event([0x90, n, 100]))
           for i, n in enumerate(CHORD16)]
    jax_pair = _jax_pair("island", world, jbuild, 64, "block", jev, 4,
                         "audio_out")
    port = _once("island", lambda: _port_render(
        voice_echo_graph, 64, "block", tev, 4, "audio_out"))
    _check(res[0]["out"], port, jax_pair, 1e-5, rtol=1e-6)
    assert np.abs(port).max() > 0.05


def test_voice_nodes_shard_only_those_nodes(ranks):
    """``voice_nodes`` narrows the sharded nodes (sample mode): the
    oscillators' leaves are slices, the filters' replicated, and the render
    equals the unsharded one bit for bit."""
    world, res = _case(ranks, "voice_nodes")
    _, port, _ = poly_render(8, 64, "sample", CHORD8, 3, 2, shard=False)
    for r in res:
        assert r["oscs"] == ["Shard"] and r["filts"] == ["Replicate"]
        np.testing.assert_array_equal(r["out"], port)


@pytest.mark.parametrize("mode", ["block", "sample"])
def test_sharded_checkpoint_round_trip(ranks, mode):
    """``save_state`` on a sharded graph writes the whole state (every
    rank the same), equal to the unsharded graph's after the same block;
    ``load_state`` into a fresh sharded graph continues bit for bit, and
    the checkpoint also loads into an unsharded graph."""
    from oscen_tpu_torch.models.poly_synth import build_poly_synth
    from oscen_tpu_torch.utils.checkpoint import load_state
    from oscen_tpu_torch.utils.convert import state_to_numpy
    world, res = _case(ranks, f"checkpoint_{mode}")

    def graph():
        return build_poly_synth(8).compile(SR, block_size=64, mode=mode,
                                           device="cpu")
    whole = graph()
    for n in CHORD8[:4]:
        whole.queue_event("midi_in", 0, T.raw_midi_event([0x90, n, 100]))
    whole.process_block()
    want = state_to_numpy(whole.state)
    want_leaves = _leaves(want)
    for r in res:
        np.testing.assert_array_equal(r["resumed"], r["cont"])
        got = _leaves(r["state"])
        assert len(got) == len(want_leaves)
        for a, b in zip(got, want_leaves):
            assert np.shape(a) == np.shape(b)
            np.testing.assert_allclose(a, b, atol=2e-6, rtol=0)
        for a, b in zip(got, _leaves(res[0]["state"])):
            np.testing.assert_array_equal(a, b)
    fresh = graph()
    load_state(fresh, res[0]["path"])
    out = np.concatenate([fresh.process_block()["audio_out"].numpy()
                          for _ in range(2)])
    np.testing.assert_allclose(out, res[0]["cont"], atol=2e-6, rtol=0)
    assert np.abs(out).max() > 0.01


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_ranks_stage_the_same_bytes(ranks):
    """Every rank's host control plane (MIDI, allocation, staging) runs
    the same schedule: each block stages the same bytes on every rank
    before each takes its slice."""
    world, results = ranks
    for name, first in results[0].items():
        if "staged" not in first:
            continue
        assert first["staged"], name
        for r in results[1:]:
            assert r[name]["staged"] == first["staged"], name
