"""oscen_tpu_torch nodes against their JAX counterparts on the CPU: the
tremolo's block path, the host MIDI / voice-allocation nodes, the
amplitude source and oscillator bank with mid-block gate events (three
instances on the instance axis), and the oscillator's power tables.

Inputs come from ``numpy.random.default_rng`` and go to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.core.events import EventBuffer as JEventBuffer
from oscen_tpu.nodes import electric_piano as jep
from oscen_tpu_torch.core.events import EventBuffer as TEventBuffer
from oscen_tpu_torch.nodes import electric_piano as tep

SR = 48000.0


def _tn(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ #
# Tremolo
# ------------------------------------------------------------------ #
def test_tremolo_block_path_matches_jax():
    """Constant-rate blocks (with a rate change at a block boundary and a
    K_REBASE crossing) and a ramping-rate block, against the JAX block
    path (its default cond form).  The pan's sine is the only
    transcendental: 1e-6."""
    B = 64
    rng = np.random.default_rng(1)
    jt, tt = J.Tremolo(), T.Tremolo()
    sr_j, sr_t = J.SampleRate(SR), T.SampleRate(SR)
    k0 = jt.K_REBASE - 100   # crosses the rebase in the second block
    st_j = {"anchor": jnp.float32(0.25), "k": jnp.int32(k0),
            "dt_last": jnp.float32(5.0 / SR)}
    st_t = {"anchor": torch.tensor(0.25), "k": torch.tensor(
        k0, dtype=torch.int32), "dt_last": torch.tensor(np.float32(5.0 / SR))}
    rates = [np.full(B, 5.0), np.full(B, 5.0), np.full(B, 8.0),
             np.linspace(8.0, 3.0, B)]
    for rate in rates:
        x = rng.normal(size=B).astype(np.float32)
        rate = rate.astype(np.float32)
        depth = np.full(B, 0.3, np.float32)
        const = frozenset({"rate", "depth"}) if rate[0] == rate[-1] \
            else frozenset({"depth"})
        st_j, out_j = jt.process_block(
            st_j, {"input": jnp.asarray(x), "rate": jnp.asarray(rate),
                   "depth": jnp.asarray(depth)}, {}, sr_j, B)
        st_t, out_t = tt.process_block(
            st_t, {"input": _tn(x), "rate": _tn(rate), "depth": _tn(depth)},
            {}, sr_t, B, const_ins=const)
        assert out_t["output"].shape == (B, 2)
        np.testing.assert_allclose(_np(out_t["output"]),
                                   _np(out_j["output"]), atol=1e-6, rtol=0)
        assert int(st_t["k"]) == int(st_j["k"])
        np.testing.assert_allclose(float(st_t["anchor"]),
                                   float(st_j["anchor"]), atol=1e-7)


# ------------------------------------------------------------------ #
# host nodes
# ------------------------------------------------------------------ #
def _events_key(evs):
    out = []
    for e in evs:
        p = e.payload
        if isinstance(p, (int, float)):
            out.append((e.frame_offset, float(p)))
        else:
            out.append((e.frame_offset, type(p).__name__,
                        tuple(sorted(vars(p).items()))))
    return out


def test_midi_parser_matches_jax():
    msgs = [(0, [0x90, 60, 100]), (3, [0x90, 64, 0]), (5, [0x80, 61, 7]),
            (9, [0xB0, 7, 100]), (11, [0x90, 67]), (12, [0x91, 72, 127])]
    outs = []
    for pkg in (J, T):
        evs = [pkg.EventInstance(o, pkg.raw_midi_event(m)) for o, m in msgs]
        ev_out, vals = pkg.MidiParser().host_process(64, {"midi_in": evs},
                                                     {})
        outs.append({k: _events_key(v) for k, v in ev_out.items()})
        assert vals == {}
    assert outs[0] == outs[1]
    assert len(outs[1]["note_on"]) == 2 and len(outs[1]["note_off"]) == 2


def test_voice_allocator_stealing_matches_jax():
    """Free voices first, then steal released-then-oldest."""
    def run(pkg):
        alloc = pkg.VoiceAllocator(4)
        on = lambda o, n: pkg.EventInstance(o, pkg.NoteOnEvent(n, 0.8))
        off = lambda o, n: pkg.EventInstance(o, pkg.NoteOffEvent(n))
        blocks = [
            {"note_on": [on(0, 60), on(1, 62), on(2, 64), on(3, 66)]},
            {"note_off": [off(4, 62)], "note_on": [on(8, 67)]},
            {"note_on": [on(0, 69), on(0, 71)], "note_off": [off(2, 69)]},
        ]
        res = []
        for b in blocks:
            ev, _ = alloc.host_process(64, b, {})
            res.append([_events_key(v) for v in ev["voices"]])
        return res, [(v.active, v.released, v.note) for v in alloc._state]

    assert run(T) == run(J)


def test_midi_voice_handler_matches_jax():
    """Block-constant frequency, one step (StepValue), two steps (host
    array) and gate events."""
    def run(pkg):
        h = pkg.MidiVoiceHandler()
        on = lambda o, n: pkg.EventInstance(o, pkg.NoteOnEvent(n, 0.5))
        off = lambda o, n: pkg.EventInstance(o, pkg.NoteOffEvent(n))
        blocks = [{}, {"note_on": [on(5, 60)]},
                  {"note_off": [off(20, 60)], "note_on": [on(2, 64),
                                                          on(30, 65)]},
                  {"note_off": [off(0, 65)]}]
        res = []
        for b in blocks:
            ev, vals = h.host_process(64, b, {})
            f = vals["frequency"]
            f = (("step", f.base, f.offset, f.target)
                 if type(f).__name__ == "StepValue"
                 else ("array", np.asarray(f).tolist()))
            res.append((_events_key(ev["gate"]), f))
        return res

    assert run(T) == run(J)


# ------------------------------------------------------------------ #
# amplitude source / oscillator bank with mid-block gate events
# ------------------------------------------------------------------ #
def _gate_blocks():
    """Per block: (offsets, values, valid) [3, 2] for three instances."""
    return [
        (np.array([[0, 40], [10, 0], [0, 0]], np.int32),
         np.array([[0.8, 0.0], [0.5, 0.0], [0.0, 0.0]], np.float32),
         np.array([[True, True], [True, False], [False, False]])),
        (np.array([[0, 0], [50, 0], [7, 63]], np.int32),
         np.array([[0.0, 0.0], [0.0, 0.0], [0.9, 0.0]], np.float32),
         np.array([[False, False], [True, False], [True, True]])),
    ]


def _run_both(jnode, tnode, ins_np, B=64):
    C = 3
    sr_j, sr_t = J.SampleRate(SR), T.SampleRate(SR)
    st_j = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(jnp.asarray(x),
                                   (C,) + jnp.shape(jnp.asarray(x))).copy(),
        jnode.init_state(sr_j))
    st_t = jax.tree_util.tree_map(lambda x: torch.tensor(np.asarray(x)),
                                  st_j)
    outs = []
    for b, (off, val, ok) in enumerate(_gate_blocks()):
        ins = {k: v[b] for k, v in ins_np.items()}
        ev_j = JEventBuffer(jnp.asarray(off), jnp.asarray(val),
                            jnp.asarray(ok))
        st_j, out_j = jax.vmap(lambda s, i, e: jnode.process_block(
            s, i, {"gate": e}, sr_j, B))(
            st_j, {k: jnp.asarray(v) for k, v in ins.items()}, ev_j)
        st_t, out_t = tnode.process_block(
            st_t, {k: _tn(v) for k, v in ins.items()},
            {"gate": TEventBuffer(_tn(off), _tn(val), _tn(ok))}, sr_t, B)
        outs.append((out_j, out_t, st_j, st_t))
    return outs


def _params(C, B, blocks=2):
    full = lambda v: np.full((blocks, C, B), v, np.float32)
    freq = full(440.0)
    freq[0, 0] = 220.0
    freq[0, 1, 10:] = 330.0   # steps at instance 1's gate offset
    freq[1, 1] = 330.0
    freq[1, 2, 7:] = 523.25
    return {"frequency": freq, "brightness": full(30.0),
            "velocity_scaling": full(50.0), "decay_rate": full(90.0),
            "harmonic_decay": full(70.0), "key_scaling": full(50.0),
            "release_rate": full(40.0)}


def test_amplitude_source_gate_events_match_jax():
    outs = _run_both(jep.AmplitudeSource(), tep.AmplitudeSource(),
                     _params(3, 64))
    for out_j, out_t, st_j, st_t in outs:
        a_j, a_t = _np(out_j["amplitudes"]), _np(out_t["amplitudes"])
        assert a_t.shape == (3, 64, 32) and np.abs(a_j).max() > 0.05
        np.testing.assert_allclose(a_t, a_j, atol=2e-6, rtol=0)
        for k in st_j:
            assert _np(st_t[k]).dtype == np.asarray(st_j[k]).dtype, k
            np.testing.assert_allclose(_np(st_t[k]), np.asarray(st_j[k]),
                                       atol=2e-6, rtol=0)


def test_oscillator_bank_gate_events_match_jax():
    rng = np.random.default_rng(2)
    ins = _params(3, 64)
    ins = {"frequency": ins["frequency"],
           "amplitudes": rng.uniform(0, 0.1, (2, 3, 64, 32)).astype(
               np.float32)}
    outs = _run_both(jep.OscillatorBank(), tep.OscillatorBank(), ins)
    # the rotations come from the power tables, whose product order
    # differs (test_power_tables_match_jax): 1e-5 on unit-modulus state
    for out_j, out_t, st_j, st_t in outs:
        y_j, y_t = _np(out_j["output"]), _np(out_t["output"])
        assert y_t.shape == (3, 64) and np.abs(y_j).max() > 0.1
        np.testing.assert_allclose(y_t, y_j, atol=1e-5, rtol=0)
        for k in st_j:
            np.testing.assert_allclose(_np(st_t[k]), np.asarray(st_j[k]),
                                       atol=1e-5, rtol=0)


@pytest.mark.parametrize("B", [64, 1024])
def test_power_tables_match_jax(B):
    """The split power tables, built by doubling here and by an
    associative scan in the JAX package: the same powers up to
    product-order rounding, which grows with the exponent.  Largest
    deviation over 32 harmonics of three notes (unit-modulus z): 9.5e-6
    at B=1024 (exponents up to 1040); the bound is 2e-5."""
    freq = np.array([110.0, 440.0, 1760.0], np.float32)
    mre_j, mim_j = jax.vmap(
        lambda f: jep.OscillatorBank._multipliers(f, SR))(jnp.asarray(freq))
    mre_t, mim_t = tep.OscillatorBank._multipliers(_tn(freq), SR)
    np.testing.assert_allclose(_np(mre_t), np.asarray(mre_j), atol=2e-7)
    np.testing.assert_allclose(_np(mim_t), np.asarray(mim_j), atol=2e-7)
    tabs_t = tep._complex_pow_tables(_tn(np.asarray(mre_j)),
                                     _tn(np.asarray(mim_j)), B)
    for c in range(3):
        tabs_j = jep._complex_pow_tables(mre_j[c], mim_j[c], B)
        for a, b in zip(tabs_t, tabs_j):
            np.testing.assert_allclose(_np(a[c]), np.asarray(b), atol=2e-5,
                                       rtol=0)
