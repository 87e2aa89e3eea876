"""The rank bodies of ``tests/test_torch_parallel.py``: voice-sharded
renders of the port over gloo processes on the CPU.

Not a test file (pytest does not collect it).  ``run`` is what
``torch.multiprocessing.spawn`` starts in each rank: it joins a gloo group
through a ``FileStore`` in a temporary directory (no network port), renders
every case of ``CASES`` sharded over the group's ranks, and saves what each
case returned to ``rank<r>.pt`` there.  It imports the port only, never
JAX, so spawned ranks start without it.  The schedules are those of
``tests/test_multichip.py``.

Each rank also records, per block, a digest of everything it staged before
taking its slice (the host values and event buffers), so the test can check
that every rank's host control plane produced the same bytes.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

import oscen_tpu_torch as T
from oscen_tpu_torch.models.electric_piano import build_electric_piano
from oscen_tpu_torch.models.fm_synth import build_fm_synth
from oscen_tpu_torch.models.poly_synth import build_poly_synth
from oscen_tpu_torch.utils.checkpoint import load_state, save_state
from oscen_tpu_torch.parallel.voices import (shard_compiled_state,
                                             voice_mesh, voice_sharding)

SR = 48000.0
CHORD8 = (48, 52, 55, 59, 60, 64, 67, 71)
CHORD16 = CHORD8 + (43, 45, 47, 50, 53, 57, 62, 65)


def _digests(c) -> list:
    """Wrap ``c._stage`` to record a digest of what each block stages."""
    seen = []
    stage = c._stage

    def recorded(B, ev_np, host_vals, stream_inputs=None):
        h = hashlib.sha1()
        for k in sorted(host_vals):
            h.update(k.encode() + np.ascontiguousarray(host_vals[k]).tobytes())
        for k in sorted(ev_np):
            b = ev_np[k]
            for a in (b.offsets, b.values, b.valid):
                h.update(k.encode() + np.ascontiguousarray(a).tobytes())
        seen.append(h.hexdigest())
        return stage(B, ev_np, host_vals, stream_inputs)
    c._stage = recorded
    return seen


def render(c, blocks: int, out: str, events=()):
    """Queue ``events`` ((endpoint, offset, payload)) and render
    ``blocks`` blocks of output ``out``."""
    for ep, off, payload in events:
        c.queue_event(ep, off, payload)
    return np.concatenate([c.process_block()[out].numpy()
                           for _ in range(blocks)])


def poly_render(voices, B, mode, notes, spacing, blocks, shard=True,
                voice_nodes=None):
    c = build_poly_synth(voices).compile(SR, block_size=B, mode=mode,
                                         device="cpu")
    if shard:
        shard_compiled_state(c, voice_mesh(device="cpu"), voice_nodes)
    seen = _digests(c)
    evs = [("midi_in", i * spacing, T.raw_midi_event([0x90, n, 100]))
           for i, n in enumerate(notes)]
    return c, render(c, blocks, "audio_out", evs), seen


def scalar_env_graph():
    """``tests/test_multichip.py``'s 8 oscillators into one scalar
    envelope's VCA: 8 gate events round the scalar node's buffer capacity
    to 8, the array's count."""
    g = T.Graph("ScalarEnvVoices")
    g.input("gate_in", "event")
    g.output("audio_out", "stream")
    oscs = g.add("oscs", T.Oscillator(frequency=220.0), count=8)
    env = g.add("env", T.AdsrEnvelope(attack=0.001, decay=0.05, sustain=0.6,
                                      release=0.1))
    vca = g.add("vca", T.Vca())
    g.connect("gate_in", env.gate)
    g.connect(oscs.output, vca.input)   # fan-in sum over voices
    g.connect(env.output, vca.control)
    g.connect(vca.output, "audio_out")
    return g


def voice_echo_graph():
    """``tests/test_multichip.py``'s 16 per-voice feedback cycles
    (osc -> mix -> delay -> mix), a scan island of node arrays."""
    g = T.Graph("VoiceEcho")
    g.input("midi_in", "event")
    g.output("audio_out", "stream")
    parser = g.add("parser", T.MidiParser())
    alloc = g.add("alloc", T.VoiceAllocator(16))
    handlers = g.add("handlers", T.MidiVoiceHandler(), count=16)
    oscs = g.add("oscs", T.Oscillator(frequency=220.0), count=16)
    mix = g.add("mix", T.Mixer(), count=16)
    d = g.add("d", T.Delay(50.0, 0.0), count=16)
    g.connect("midi_in", parser.midi_in)
    g.connect(parser.note_on, alloc.note_on)
    g.connect(parser.note_off, alloc.note_off)
    g.connect(alloc.voices, handlers.note_on)
    g.connect(handlers.frequency, oscs.frequency)
    g.connect(oscs.output, mix.input_a)
    g.connect(mix.output, d.input)
    g.connect(d.output, mix.input_b, feedback=True)
    g.connect(d.output, "audio_out")   # fan-in over voices
    return g


def _sharded(build, B):
    c = build().compile(SR, block_size=B, mode="block", device="cpu")
    shard_compiled_state(c, voice_mesh(device="cpu"))
    return c


def case_render(world, mode):
    _, out, seen = poly_render(8, 128, mode, CHORD8, 3, 3)
    return {"out": out, "staged": seen}


def case_placement(world):
    """The state's placements; then the setter: the ``DTensor`` state set
    back continues bit for bit as a twin that was not touched, and a full
    (unsharded) state continues as the unsharded graph it came from."""
    graphs = [build_poly_synth(8).compile(SR, block_size=64, device="cpu")
              for _ in range(3)]
    mesh = voice_mesh(device="cpu")
    c, twin, whole = graphs
    for g in (c, twin):
        shard_compiled_state(g, mesh)
    leaf = c.state["oscs"]["phase"]
    outs = []
    for g in graphs:
        g.queue_event("midi_in", 0, T.raw_midi_event([0x90, 60, 100]))
        outs.append(g.process_block()["audio_out"].numpy())
    out = outs[0]
    st = c.state
    c.state = st
    roundtrip = (c.process_block()["audio_out"].numpy(),
                 twin.process_block()["audio_out"].numpy())
    c.state = {k: _to_numpy(v) for k, v in whole.state.items()}
    from_full = (c.process_block()["audio_out"].numpy(),
                 whole.process_block()["audio_out"].numpy())
    return {"type": type(leaf).__name__,
            "shard0": tuple(leaf.placements) == (voice_sharding(mesh),),
            "global": tuple(leaf.shape), "local": tuple(leaf.to_local().shape),
            # the placements of every node array's leaves, and the rest's
            "arrays": sorted({type(p).__name__ for name, sub in st.items()
                              if name in c.ir.nodes
                              and c.ir.nodes[name].count > 1
                              for x in _leaves(sub) for p in x.placements}),
            "rest": sorted({type(p).__name__ for name, sub in st.items()
                            if name not in c.ir.nodes
                            or c.ir.nodes[name].count == 1
                            for x in _leaves(sub) for p in x.placements}),
            "out": out, "roundtrip": roundtrip, "from_full": from_full}


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree.numpy()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def case_poly32(world):
    _, out, seen = poly_render(32, 64, "block", CHORD8[:4], 5, 3)
    return {"out": out, "staged": seen}


def case_piano16(world):
    c = _sharded(lambda: build_electric_piano(16), 64)
    seen = _digests(c)
    evs = [("midi_in", 0, T.raw_midi_event([0x90, 48 + i * 3, 100]))
           for i in range(8)]
    return {"out": render(c, 3, "out", evs), "staged": seen}


def case_divisible(world):
    voices = 6 if world == 8 else 3
    c = build_poly_synth(voices).compile(SR, block_size=64, mode="block",
                                         device="cpu")
    shard_compiled_state(c, voice_mesh(device="cpu"))
    c.queue_event("midi_in", 0, T.raw_midi_event([0x90, 60, 100]))
    try:
        c.process_block()
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def case_fm16(world):
    c = _sharded(lambda: build_fm_synth(16), 64)
    seen = _digests(c)
    evs = [("midi_in", 0, T.raw_midi_event([0x90, n, 100]))
           for n in (48, 55, 60, 64)]
    return {"out": render(c, 3, "audio_out", evs), "staged": seen}


def case_steady(world):
    c = _sharded(lambda: build_poly_synth(16), 64)
    for n in (48, 55, 60, 64):
        c.queue_event("midi_in", 0, T.raw_midi_event([0x90, n, 100]))
    c.process_block()   # consume the events
    out = c.render_steady(4)["audio_out"].numpy()
    return {"out": out, "checksum": c.steady_checksum(4)}


def case_scalar_events(world):
    c = _sharded(scalar_env_graph, 64)
    seen = _digests(c)
    evs = [("gate_in", i * 7, 0.5 + 0.05 * i) for i in range(8)]
    buf_cap = []
    stage = c._stage

    def capture(B, ev_np, host_vals, stream_inputs=None):
        staging = stage(B, ev_np, host_vals, stream_inputs)
        buf_cap.append(tuple(staging.unpack()[1]["env.gate"].offsets.shape))
        return staging
    c._stage = capture
    return {"out": render(c, 3, "audio_out", evs), "staged": seen,
            "env_buffer": buf_cap}


def case_island(world):
    c = _sharded(voice_echo_graph, 64)
    seen = _digests(c)
    evs = [("midi_in", i % 5, T.raw_midi_event([0x90, n, 100]))
           for i, n in enumerate(CHORD16)]
    return {"out": render(c, 4, "audio_out", evs), "staged": seen}


def case_voice_nodes(world):
    c, out, _ = poly_render(8, 64, "sample", CHORD8, 3, 2,
                            voice_nodes=("oscs",))
    st = c.state
    return {"out": out,
            "oscs": [type(p).__name__ for p in st["oscs"]["phase"].placements],
            "filts": sorted({type(p).__name__
                             for leaf in st["filts"].values()
                             for p in leaf.placements})}


def case_checkpoint(world, mode, tmp):
    """A sharded poly synth saved after its chord block (each rank gathers
    the whole state into its own file) and restored into a fresh sharded
    graph, which continues as the saved one does."""
    def sharded():
        c = build_poly_synth(8).compile(SR, block_size=64, mode=mode,
                                        device="cpu")
        return shard_compiled_state(c, voice_mesh(device="cpu"))
    c = sharded()
    for n in CHORD8[:4]:
        c.queue_event("midi_in", 0, T.raw_midi_event([0x90, n, 100]))
    c.process_block()
    path = os.path.join(tmp, f"ckpt_{mode}_rank{dist.get_rank()}.pkl")
    save_state(c, path)
    with open(path, "rb") as f:
        saved = pickle.load(f)["state"]
    cont = render(c, 2, "audio_out")
    r = sharded()
    load_state(r, path)
    return {"state": saved, "path": path, "cont": cont,
            "resumed": render(r, 2, "audio_out")}


# case_replays' models: build function, output, the parameter it ramps
REPLAY_MODELS = {
    "piano": (build_electric_piano, "out", ("vibrato_intensity", 0.6)),
    "poly": (build_poly_synth, "audio_out", ("resonance", 0.5)),
}


def replay_render(model, jit=True, shard=True):
    """The 16-voice ``model`` of REPLAY_MODELS at B=64, sharded over the
    group or not: a chord, 4 steady blocks, a ramp of 2 blocks and
    ``render_steady(2)``; returns (the output, the graph)."""
    build, out, (name, target) = REPLAY_MODELS[model]
    c = build(16).compile(SR, block_size=64, mode="block", device="cpu",
                          jit=jit)
    if shard:
        shard_compiled_state(c, voice_mesh(device="cpu"))
    evs = [("midi_in", 0, T.raw_midi_event([0x90, 48 + i * 3, 100]))
           for i in range(8)]
    y = render(c, 5, out, evs)
    c.set_value_with_ramp(name, target, 128)
    return np.concatenate([y, render(c, 2, out),
                           c.render_steady(2)[out].numpy()]), c


def case_replays(world, model):
    """``replay_render`` sharded with ``jit=True`` (the CPU stand-in
    replays its captured blocks) and with ``jit=False``."""
    y, c = replay_render(model)
    return {"out": y, "eager": replay_render(model, jit=False)[0],
            "counts": c.block_counts, "why": c.eager_why,
            "backend": c._shard_backend}


CASES = {
    "render_sample": lambda w: case_render(w, "sample"),
    "replay_piano": lambda w: case_replays(w, "piano"),
    "replay_poly": lambda w: case_replays(w, "poly"),
    "render_block": lambda w: case_render(w, "block"),
    "placement": case_placement,
    "poly32": case_poly32,
    "piano16": case_piano16,
    "divisible": case_divisible,
    "fm16": case_fm16,
    "steady": case_steady,
    "scalar_events": case_scalar_events,
    "island": case_island,
    "voice_nodes": case_voice_nodes,
    "checkpoint_block": lambda w, tmp: case_checkpoint(w, "block", tmp),
    "checkpoint_sample": lambda w, tmp: case_checkpoint(w, "sample", tmp),
}


def run(rank: int, world: int, tmp: str) -> None:
    """One rank: join the gloo group, render every case, save the results
    (a failure raises, and ``spawn`` re-raises it in the parent)."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        results = {name: fn(world, tmp) if name.startswith("checkpoint")
                   else fn(world) for name, fn in CASES.items()}
        torch.save(results, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
