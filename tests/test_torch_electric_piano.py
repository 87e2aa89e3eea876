"""The electric-piano slice end to end: oscen_tpu_torch on the CPU against
the JAX package, and the port's own invariants.

Sequence: a chord at offsets 0 and 17 (an event block), 4 steady blocks,
a note-off block, 2 steady blocks, all through the public API
(``build_electric_piano`` -> ``compile`` -> ``queue_event`` /
``process_block``).  On the CPU the port's steady blocks run the plain
version of the fused v4 kernel; the JAX package's run the composed closed
forms, or the Pallas kernel in interpret mode with
``OSCEN_PALLAS_INTERPRET=1``.
"""

import jax
import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.models.electric_piano import build_electric_piano as jbuild
from oscen_tpu_torch.models.electric_piano import build_electric_piano as tbuild
from oscen_tpu_torch.ops.cuda import additive as tadd
from oscen_tpu_torch.utils.convert import state_from_jax, state_to_numpy

SR = 48000.0


def _cpu(pkg):
    """The port's graphs compile for the card unless asked for the CPU; the
    JAX package's ``compile`` takes no device."""
    return {"device": "cpu"} if pkg is T else {}


def _sequence(pkg, p):
    outs = []
    for i, n in enumerate((60, 64, 67, 71)):
        p.queue_event("midi_in", 0 if i < 2 else 17,
                      pkg.raw_midi_event([0x90, n, 100]))
    outs.append(p.process_block()["out"])
    outs += [p.process_block()["out"] for _ in range(4)]
    p.queue_event("midi_in", 5, pkg.raw_midi_event([0x80, 60, 0]))
    outs.append(p.process_block()["out"])
    outs += [p.process_block()["out"] for _ in range(2)]
    return np.concatenate([np.asarray(o) for o in outs])


@pytest.mark.parametrize("fused", [True, False])
def test_slice_matches_jax_composed(fused):
    """Port (plain v4 on steady blocks) against JAX's composed path:
    atol 1e-4 (measured ~2e-5; the power tables and the closed forms'
    transcendentals differ at ulp level)."""
    a = _sequence(J, jbuild(8, fused=fused).compile(SR, block_size=64))
    b = _sequence(T, tbuild(8, fused=fused).compile(SR, block_size=64,
                                                    device="cpu"))
    assert b.shape == a.shape == (8 * 64, 2)
    assert np.abs(a).max() > 0.5
    np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)


def test_slice_matches_jax_pallas_interpret(monkeypatch):
    """With OSCEN_PALLAS_INTERPRET=1 the JAX package's steady blocks run
    its Pallas v4 kernel (B=32: U=32, SUB=32), the same closed form as the
    port's: max abs 5e-5 (measured ~6e-6)."""
    monkeypatch.setenv("OSCEN_PALLAS_INTERPRET", "1")
    a = _sequence(J, jbuild(8).compile(SR, block_size=32))
    b = _sequence(T, tbuild(8).compile(SR, block_size=32, device="cpu"))
    assert np.abs(a - b).max() <= 5e-5


def test_single_voice_matches_jax():
    """One voice subgraph used as a scalar node (count 1: the batched
    nodes run as one instance) with gate events, against JAX: 1e-4."""
    from oscen_tpu.models.electric_piano import build_voice as jvoice
    from oscen_tpu_torch.models.electric_piano import build_voice as tvoice

    def run(pkg, build_voice):
        g = pkg.Graph("V")
        g.input("gate", "event")
        g.input("frequency", "value", default=440.0)
        g.output("out", "stream")
        v = g.add("voice", build_voice())
        g.connect("gate", v.gate)
        g.connect("frequency", v.frequency)
        g.connect(v.output, "out")
        c = g.compile(SR, block_size=64, **_cpu(pkg))
        c.queue_event("gate", 10, 1.0)
        out = [c.render_mono(128)]
        c.set_value("frequency", 330.0)
        c.queue_event("gate", 3, 0.0)
        out.append(c.render_mono(128))
        return np.concatenate(out)

    a, b = run(J, jvoice), run(T, tvoice)
    assert np.abs(a).max() > 0.1
    np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)


def test_fused_matches_subgraph():
    """The fused voice node (one kernel call per steady block) equals the
    two-node subgraph (composed closed forms): RMS < 1e-5."""
    a = _sequence(T, tbuild(8, fused=True).compile(SR, block_size=64,
                                                   device="cpu"))
    b = _sequence(T, tbuild(8, fused=False).compile(SR, block_size=64,
                                                    device="cpu"))
    assert np.sqrt(np.mean((a - b) ** 2)) < 1e-5


def _invariance_run(B):
    p = tbuild(8).compile(SR, block_size=B, device="cpu")
    for i, n in enumerate((60, 64, 67)):
        p.queue_event("midi_in", 17 * i, T.raw_midi_event([0x90, n, 100]))
    outs = [p.process_block(64)["out"]]    # the same event block in both
    outs += [p.process_block()["out"] for _ in range(256 // B)]
    return torch.cat(outs).numpy()


def test_block_size_invariance(monkeypatch):
    """Steady blocks at B=64 against B=32 after the same event block.  The
    exact-op-order kernel is bit-exact across block sizes.  v4 is not: its
    subgroup length SUB = min(U, 64) follows the block size and moves the
    closed form's anchor (64 -> 32 here), which the JAX package pins for
    no model either; it stays at the rounding level (measured 2.4e-6)."""
    monkeypatch.setenv("OSCEN_ADDITIVE_KERNEL", "parity")
    np.testing.assert_array_equal(_invariance_run(64), _invariance_run(32))
    monkeypatch.setenv("OSCEN_ADDITIVE_KERNEL", "v4")
    np.testing.assert_allclose(_invariance_run(64), _invariance_run(32),
                               atol=1e-5, rtol=0)


def test_state_from_jax_carries_the_state():
    """Render 2 blocks in JAX, carry its state into the port (whose host
    nodes saw the same events), render one more steady block in both."""
    jp = jbuild(8).compile(SR, block_size=64)
    tp = tbuild(8).compile(SR, block_size=64, device="cpu")
    for pkg, p in ((J, jp), (T, tp)):
        for n in (60, 64, 67):
            p.queue_event("midi_in", 9, pkg.raw_midi_event([0x90, n, 100]))
        p.process_block()
        p.process_block()
    np_state = jax.tree_util.tree_map(np.asarray, jp.state)
    tp.state = state_from_jax(np_state, device="cpu")
    back = state_to_numpy(tp.state)
    assert back["voices"]["amp"]["step"].dtype == np.int32
    assert back["voices"]["amp"]["released"].dtype == np.bool_
    assert back["tremolo"]["k"].dtype == np.int32
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, np_state)
    a = np.asarray(jp.process_block()["out"])
    b = tp.process_block()["out"].numpy()
    np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)


def test_steady_blocks_take_the_kernel_path(monkeypatch):
    p = tbuild(8).compile(SR, block_size=64, device="cpu")
    p.queue_event("midi_in", 0, T.raw_midi_event([0x90, 60, 100]))
    p.process_block()
    notes = p.explain()
    voices = [e for e in notes if e["node"] == "voices"]
    assert {"kernel": "additive_voice_v4", "fanin_mixdown_fused": True,
            "stream_epilogue_fused": False, "node": "voices"} in voices
    assert any(e.get("path") == "batched" for e in voices)
    monkeypatch.setenv("OSCEN_ADDITIVE_KERNEL", "parity")
    assert "kernel=additive_voice_parity" in p.explain(formatted=True)
    # explain() observes: the next block still equals a fresh run's
    q = tbuild(8).compile(SR, block_size=64, device="cpu")
    q.queue_event("midi_in", 0, T.raw_midi_event([0x90, 60, 100]))
    q.process_block()
    monkeypatch.delenv("OSCEN_ADDITIVE_KERNEL")
    assert torch.equal(p.process_block()["out"], q.process_block()["out"])


def test_partial_blocks_take_the_composed_path():
    """Blocks whose length is not a multiple of 8 have no kernel path
    (process_block_batched returns None) and compose the closed forms."""
    p = tbuild(4).compile(SR, block_size=100, device="cpu")
    p.queue_event("midi_in", 0, T.raw_midi_event([0x90, 60, 100]))
    out = p.render(990)["out"]  # 9 full blocks + a 90-sample tail
    assert out.shape == (990, 2)
    assert np.all(np.isfinite(out)) and np.abs(out).max() > 0.01
    assert p.explain()[0] == {"node": "voices", "path": "vmap"}


def test_render_steady_and_checksum():
    """render_steady and steady_checksum run the same steady blocks; the
    checksum is the energy of what render_steady returns."""
    runs = []
    for _ in range(2):
        p = tbuild(8).compile(SR, block_size=64, device="cpu")
        p.queue_event("midi_in", 0, T.raw_midi_event([0x90, 64, 100]))
        p.process_block()
        runs.append(p)
    before = dict(tadd.launches)
    y = runs[0].render_steady(3)["out"]
    ck = runs[1].steady_checksum(3)
    assert y.shape == (192, 2)
    assert ck == pytest.approx(float((y ** 2).sum()), rel=1e-6)
    assert tadd.launches == before   # CPU tensors: plain versions
    for a, b in zip(jax.tree_util.tree_leaves(state_to_numpy(runs[0].state)),
                    jax.tree_util.tree_leaves(state_to_numpy(runs[1].state))):
        np.testing.assert_array_equal(a, b)


def _tremolo_run(pkg, build, **kw):
    """The JAX package's epilogue-fusion sequence
    (tests/test_electric_piano.py:394-420) at 4 voices, B=256: a chord,
    1536 samples, a tremolo rate change at a block boundary, 512 samples,
    a ramping rate (staged [B]: the fusion steps aside), 512 samples."""
    s = build(4).compile(SR, block_size=256, **kw)
    for i in range(4):
        s.queue_event("midi_in", 0, pkg.raw_midi_event([0x90, 50 + 5 * i,
                                                        100]))
    out = s.render(1536)["out"]
    s.set_value("vibrato_speed", 8.0)
    out2 = s.render(512)["out"]
    s.set_value_with_ramp("vibrato_speed", 3.0, 300)
    out3 = s.render(512)["out"]
    return np.concatenate([out, out2, out3]), s


def test_tremolo_epilogue_fusion_parity(monkeypatch):
    """OSCEN_EPILOGUE_FUSION=1: the tremolo's pan runs after the mix in the
    voice kernel's plain version, bit-identical to the unfused piano and
    with the same tremolo state; the unfused piano within the slice's
    1e-4 of the JAX package's composed render (which the JAX package pins
    bit-equal to its fused one)."""
    runs = {}
    for fused in (True, False):
        monkeypatch.setenv("OSCEN_EPILOGUE_FUSION", "1" if fused else "0")
        runs[fused] = _tremolo_run(T, tbuild, device="cpu")
        notes = runs[fused][1].explain()
        assert ({"node": "tremolo", "path": "fused_into_producer_epilogue"}
                in notes) == fused
    (a, sa), (b, sb) = runs[True], runs[False]
    np.testing.assert_array_equal(a, b)
    for k in sb.node_state("tremolo"):
        assert torch.equal(sa.node_state("tremolo")[k],
                           sb.node_state("tremolo")[k])
    monkeypatch.setenv("OSCEN_EPILOGUE_FUSION", "0")
    j, _ = _tremolo_run(J, jbuild)
    assert np.abs(j).max() > 0.5
    np.testing.assert_allclose(b, j, atol=1e-4, rtol=0)


def test_epilogue_fusion_steps_aside_for_a_ramp(monkeypatch):
    """The dynamic half: a rate ramping through the block is staged [B], so
    that block runs the tremolo on its own; a parity kernel never fuses."""
    monkeypatch.setenv("OSCEN_EPILOGUE_FUSION", "1")
    p = tbuild(4).compile(SR, block_size=64, device="cpu")
    p.queue_event("midi_in", 0, T.raw_midi_event([0x90, 60, 100]))
    p.process_block()
    fused = {"node": "voices", "epilogue_fused_consumer": "tremolo"}
    assert fused in p.explain()
    p.set_value_with_ramp("vibrato_speed", 3.0, 300)
    assert fused not in p.explain()
    monkeypatch.setenv("OSCEN_ADDITIVE_KERNEL", "parity")
    q = tbuild(4).compile(SR, block_size=64, device="cpu")
    q.queue_event("midi_in", 0, T.raw_midi_event([0x90, 60, 100]))
    q.process_block()
    assert fused not in q.explain()


def test_steady_blocks_copy_no_constant_to_the_device(monkeypatch):
    """The voice's numpy constants (harmonic numbers, velocity spectra, the
    envelope table) reach a block's device once, not in every block: on
    the card each copy would make the block wait for it (the card test
    runs the piano's steady blocks under sync debug mode "error")."""
    from oscen_tpu_torch.nodes import electric_piano as ep
    copies = []
    real = torch.as_tensor

    def counting(x, *a, **kw):
        if isinstance(x, np.ndarray):
            copies.append(x.shape)
        return real(x, *a, **kw)
    p = tbuild(8).compile(SR, block_size=64, device="cpu")
    for n in (60, 64, 67):
        p.queue_event("midi_in", 0, T.raw_midi_event([0x90, n, 100]))
    p.process_block()
    p.process_block()
    monkeypatch.setattr(ep.torch, "as_tensor", counting)
    for _ in range(3):
        p.process_block()
    assert copies == []
    x = ep.HARMONIC_NUMBERS
    assert ep._f32(x, torch.zeros(1)) is ep._f32(x, torch.zeros(2))
