"""Every node's per-sample ``tick`` in oscen_tpu_torch against the JAX
package's tick on the CPU, with its event handlers, for one instance and
for a node array (the port broadcasts over the instance axis; JAX ``vmap``s
its tick), and the event dispatch at host-known offsets against the masked
form.

Each case drives both packages from the same seeded numpy inputs for 16
samples, with a gate-on at sample 3 and a gate-off at 10 where the node has
a gate.  The JAX tick runs eagerly (its arithmetic op by op) unless marked
``jit``: nodes whose port divides by the sample rate as XLA compiles it
(``fmath.div_const``, a product with the float32 reciprocal) are held to
the JAX tick under ``jax.jit``, the form the JAX package's sample mode
runs.  Tolerances (absolute, on outputs and state):

- 0 (bit for bit) wherever both sides do the same float32 ops: the
  stateless nodes, the tremolo, the FM operator, the TPT and IIR filters,
  the amplitude source, the delay, and the pivot chain under ``jit``
  (whose products into sums XLA fuses into FMAs, as the port's pivot
  chain does);
- 1e-6 where XLA compiles the JAX side differently: its reciprocal
  rewrites and FMA contraction under ``jit`` (oscillators, the MulAdd), a
  correctly rounded float64 ``exp`` / ``tanh`` against XLA's float32 ones
  (ADSR within an ulp, the LP18 ``tanh`` within 4 ulp), the fm chain's
  phase step (``div_const`` against eager JAX's true quotient);
- 1e-5 for the oscillator bank and the piano voice: the rotation
  multipliers are correctly rounded ``sin`` / ``cos`` in the port and
  XLA's float32 ones in JAX, and the rotation carries that ulp along
  (measured 2.4e-6 over 24 samples with random amplitudes).

For three instances the bound is at least 1e-6 (1e-5 for the fm chain):
JAX's ``vmap``ped tick runs vectorized XLA ops (``tan``, the sine
polynomial) that round differently from its scalar ops (measured up to
2.4e-7; the fm chain's feedback carries it to 2.9e-6).  The port's array
tick equals its one-instance tick bit for bit
(``test_ticks_broadcast_over_instances_as_one_instance_each``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.models.fm_synth import FmOperatorChain as JFmChain
from oscen_tpu.models.pivot import PivotOperatorChain as JPivotChain
from oscen_tpu.nodes import electric_piano as jep
from oscen_tpu.nodes.envelope import AdsrBank as JAdsrBank
from oscen_tpu_torch.core.events import EventBuffer
from oscen_tpu_torch.graph.node import scan_tick_block, tree_map
from oscen_tpu_torch.models.fm_synth import FmOperatorChain as TFmChain
from oscen_tpu_torch.models.pivot import PivotOperatorChain as TPivotChain
from oscen_tpu_torch.nodes import electric_piano as tep
from oscen_tpu_torch.nodes.envelope import AdsrBank as TAdsrBank

SR = 48000.0
N_TICKS = 16
GATES = {3: 0.8, 10: 0.0}

# input ranges by endpoint name (or its suffix after "_"); others N(0, .5)
RANGES = {
    "frequency": (100, 2000), "base_freq": (100, 2000),
    "cutoff": (200, 8000), "cutoff_a": (300, 3000), "cutoff_b": (500, 5000),
    "q": (0.5, 2.0), "rate": (2, 9), "depth": (0, 1),
    "delay_samples": (3, 40), "feedback": (0, 0.9), "resonance": (0, 0.95),
    "attack": (1e-4, 4e-4), "decay": (1e-4, 4e-4), "sustain": (0.3, 0.9),
    "release": (1e-4, 4e-4), "ratio": (0.5, 3), "level": (0.2, 1),
    "route": (0, 1), "mix": (-0.2, 1.2), "pulse_width": (0.1, 0.9),
    "fmod": (-200, 200), "f_mod": (-0.5, 0.5), "frequency_mod": (-0.2, 0.2),
    "brightness": (10, 90), "velocity_scaling": (10, 90),
    "decay_rate": (60, 99), "harmonic_decay": (40, 90),
    "key_scaling": (10, 90), "release_rate": (20, 80),
    "amplitude": (0.1, 1.0), "gain": (-1.5, 1.5),
}

_BANK = [("a", 2e-4, 3e-4, 0.6, 2e-4), ("b", 3e-4, 2e-4, 0.5, 3e-4)]

# (id, JAX node, port node, tolerance, JAX tick under jit)
CASES = [
    ("gain", J.Gain(0.7), T.Gain(0.7), 0.0, False),
    ("vca", J.Vca(), T.Vca(), 0.0, False),
    ("value", J.Value(1.0), T.Value(1.0), 0.0, False),
    ("audio_input", J.AudioInput(), T.AudioInput(), 0.0, False),
    ("hard_clip", J.HardClip(), T.HardClip(), 0.0, False),
    ("mixer", J.Mixer(), T.Mixer(), 0.0, False),
    ("crossfade", J.Crossfade(), T.Crossfade(), 0.0, False),
    ("add_value", J.AddValue(0.2), T.AddValue(0.2), 0.0, False),
    ("mul_add", J.MulAdd(0.5, 0.1), T.MulAdd(0.5, 0.1), 1e-6, True),
    ("tremolo", J.Tremolo(), T.Tremolo(), 0.0, False),
    ("fm_operator", J.FmOperator(), T.FmOperator(), 0.0, False),
    ("osc_sine", J.Oscillator.sine(440, 0.5), T.Oscillator.sine(440, 0.5),
     1e-6, True),
    ("osc_square", J.Oscillator.square(440, 0.5),
     T.Oscillator.square(440, 0.5), 1e-6, True),
    ("osc_saw", J.Oscillator.saw(440, 0.5), T.Oscillator.saw(440, 0.5),
     1e-6, True),
] + [(f"polyblep_{w}", J.PolyBlepOscillator(440, 0.5, w),
      T.PolyBlepOscillator(440, 0.5, w), 1e-6, True)
     for w in ("sine", "saw", "square", "triangle")] + [
    ("tpt", J.TptFilter(1000, 0.7), T.TptFilter(1000, 0.7), 0.0, False),
    ("tpt_stereo", J.TptFilter(1000, 0.7, 2), T.TptFilter(1000, 0.7, 2),
     0.0, False),
    ("iir_lowpass", J.IirLowpass(1000), T.IirLowpass(1000), 0.0, False),
    ("lp18", J.LP18Filter(1000, 0.5), T.LP18Filter(1000, 0.5), 1e-6, False),
    ("dual_lp18", J.DualLP18Diff(), T.DualLP18Diff(), 1e-6, False),
    ("adsr", J.AdsrEnvelope(2e-4, 3e-4, 0.6, 2e-4),
     T.AdsrEnvelope(2e-4, 3e-4, 0.6, 2e-4), 1e-6, False),
    ("adsr_bank", JAdsrBank(_BANK), TAdsrBank(_BANK), 1e-6, False),
    ("oscillator_bank", jep.OscillatorBank(), tep.OscillatorBank(), 1e-5,
     False),
    ("amplitude_source", jep.AmplitudeSource(), tep.AmplitudeSource(), 0.0,
     False),
    ("piano_voice", jep.ElectricPianoVoice(), tep.ElectricPianoVoice(),
     1e-5, False),
    ("delay", J.Delay(10.5, 0.5), T.Delay(10.5, 0.5), 0.0, False),
    ("fm_chain", JFmChain(), TFmChain(), 1e-6, False),
    ("pivot_chain", JPivotChain(), TPivotChain(), 0.0, True),
]


def _value(rng, name, shape):
    for key, (lo, hi) in RANGES.items():
        if name == key or name.endswith("_" + key):
            return rng.uniform(lo, hi, shape).astype(np.float32)
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


def _inputs(node, rng, count):
    out = {}
    for ep in node.INPUTS:
        if ep.kind.value in ("event", "asset"):
            continue
        shape = tuple(ep.shape) if ep.shape else (
            () if ep.channels == 1 else (ep.channels,))
        out[ep.name] = _value(rng, ep.name, ((count,) if count else ())
                              + shape)
    return out


def _assert_equal(a, b):
    """Two trees of tensors equal bit for bit."""
    bad = []
    tree_map(lambda x, y: None if torch.equal(x, y) else bad.append(1), a, b)
    assert not bad


def _worst(a, b):
    """Largest absolute difference over two trees (JAX, torch)."""
    if isinstance(a, dict):
        return max([_worst(a[k], b[k]) for k in a] + [0.0])
    a, b = np.asarray(a), b.numpy()
    if a.dtype == bool:
        return float(np.any(a != b))
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64)),
                        initial=0.0))


def _drive(jn, tn, count, jit):
    """Both ticks over N_TICKS samples from one state; returns the worst
    output and state differences."""
    rng = np.random.default_rng(0)
    sr_j, sr_t = J.SampleRate(SR), T.SampleRate(SR)
    st_j = jn.init_state(sr_j)
    if count:
        st_j = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(jnp.asarray(x),
                                       (count,) + jnp.shape(x)), st_j)
    st_t = jax.tree_util.tree_map(lambda x: torch.tensor(np.asarray(x)),
                                  st_j)
    tick = jax.vmap(jn.tick, in_axes=(0, 0, None)) if count else jn.tick
    if jit:
        tick = jax.jit(tick, static_argnums=2)
    has_gate = any(ep.name == "gate" for ep in jn.INPUTS)
    base = _inputs(jn, rng, count)
    worst_out = worst_state = 0.0
    for t in range(N_TICKS):
        ins = {k: v if rng.random() < 0.7 else _value(rng, k, v.shape)
               for k, v in base.items()}
        ins_j = {k: jnp.asarray(v) for k, v in ins.items()}
        ins_t = {k: torch.tensor(v) for k, v in ins.items()}
        if has_gate and t in GATES:
            vel = np.float32(GATES[t])
            if count:
                st_j = jax.vmap(lambda s, i: jn.apply_event(
                    s, "gate", vel, sr_j, i))(st_j, ins_j)
                st_t = tn.apply_event(st_t, "gate",
                                      torch.full((count,), float(vel)),
                                      sr_t, ins_t)
            else:
                st_j = jn.apply_event(st_j, "gate", jnp.float32(vel), sr_j,
                                      ins_j)
                st_t = tn.apply_event(st_t, "gate", torch.tensor(vel), sr_t,
                                      ins_t)
        st_j, out_j = tick(st_j, ins_j, sr_j)
        st_t, out_t = tn.tick(st_t, ins_t, sr_t)
        worst_out = max(worst_out, _worst(out_j, out_t))
        worst_state = max(worst_state, _worst(st_j, st_t))
    return worst_out, worst_state


@pytest.mark.parametrize("count", [0, 3], ids=["one", "array3"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tick_matches_jax(case, count):
    name, jn, tn, tol, jit = case
    if count:
        tol = max(tol, 1e-5 if name == "fm_chain" else 1e-6)
    worst_out, worst_state = _drive(jn, tn, count, jit)
    assert worst_out <= tol and worst_state <= tol, (worst_out, worst_state)


def test_ticks_broadcast_over_instances_as_one_instance_each():
    """A node array's tick equals each instance's own tick bit for bit:
    the instance axis is only broadcast, nothing mixes instances."""
    rng = np.random.default_rng(4)
    sr = T.SampleRate(SR)
    for node in (tep.ElectricPianoVoice(), T.DualLP18Diff(),
                 T.TptFilter(900.0, 0.8, 2), T.Delay(7.25, 0.6)):
        st = tree_map(lambda x: x.expand((3,) + tuple(x.shape)).clone(),
                      node.init_state(sr))
        ins = {k: torch.tensor(v) for k, v in _inputs(node, rng, 3).items()}
        if node.has_input("gate"):
            st = node.apply_event(st, "gate", torch.full((3,), 0.9), sr,
                                  ins)
        st3, out3 = node.tick(st, ins, sr)
        for c in range(3):
            st1, out1 = node.tick(tree_map(lambda x: x[c], st),
                                  {k: v[c] for k, v in ins.items()}, sr)
            _assert_equal(tree_map(lambda x: x[c], (st3, out3)),
                          (st1, out1))


def test_delay_owned_tick_writes_its_copy_only():
    """Inside a loop the ring is copied once (own_state) and then written
    in place; the caller's ring is never written, and the result equals
    the out-of-place tick."""
    node, sr = T.Delay(5.0, 0.5), T.SampleRate(SR)
    st0 = node.init_state(sr)
    ring0 = st0["buf"].clone()
    owned, pure = node.own_state(st0), st0
    for t in range(12):
        x = {"input": torch.tensor(float(t + 1)),
             "delay_samples": torch.tensor(5.0),
             "feedback": torch.tensor(0.5)}
        owned, yo = node.tick_owned(owned, x, sr)
        pure, yp = node.tick(pure, x, sr)
        assert torch.equal(yo["output"], yp["output"])
    assert torch.equal(owned["buf"], pure["buf"])
    assert torch.equal(st0["buf"], ring0)
    assert owned["buf"].data_ptr() != st0["buf"].data_ptr()


def _gate_buffer(count):
    """Several events at one offset (and one alone), per instance."""
    off = np.array([[5, 5, 5, 9], [2, 5, 9, 9], [5, 5, 0, 0]][:count],
                   np.int32)
    val = np.array([[0.9, 0.0, 0.7, 0.0], [0.5, 0.6, 0.0, 0.8],
                    [0.3, 0.0, 0.0, 0.0]][:count], np.float32)
    ok = np.array([[1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 0, 0]][:count], bool)
    if count == 1:
        off, val, ok = off[0], val[0], ok[0]
    return EventBuffer(torch.tensor(off), torch.tensor(val), torch.tensor(ok),
                       EventBuffer.host_slots(off, ok))


@pytest.mark.parametrize("count", [1, 3])
@pytest.mark.parametrize("node", [tep.ElectricPianoVoice(),
                                  T.AdsrEnvelope(2e-4, 3e-4, 0.6, 2e-4),
                                  TAdsrBank(_BANK)],
                         ids=["piano_voice", "adsr", "adsr_bank"])
def test_events_at_host_offsets_equal_the_masked_form(node, count):
    """The handlers run only at the (t, slot) pairs the host staged
    (``EventBuffer.slots``); the result equals the JAX package's form, a
    masked handler at every slot of every sample, bit for bit — with three
    events at one offset, and instances whose events differ."""
    sr = T.SampleRate(SR)
    rng = np.random.default_rng(2)
    C = count if count > 1 else None
    st = node.init_state(sr)
    if C:
        st = tree_map(lambda x: x.expand((C,) + tuple(x.shape)).clone(), st)
    ins = {k: torch.tensor(np.repeat(v[..., None], 16, axis=-1))
           for k, v in _inputs(node, rng, C).items()}
    if not C:
        ins = {k: v.movedim(-1, 0) for k, v in ins.items()}
    else:
        ins = {k: v.movedim(-1, 1) for k, v in ins.items()}
    buf = _gate_buffer(count)
    masked = EventBuffer(buf.offsets, buf.values, buf.valid)
    taxis = 1 if C else 0
    a_st, a_out = scan_tick_block(node, st, ins, {"gate": buf}, sr, 16,
                                  taxis)
    b_st, b_out = scan_tick_block(node, st, ins, {"gate": masked}, sr, 16,
                                  taxis)
    _assert_equal((a_st, a_out), (b_st, b_out))
    assert buf.slots == ({5: (0, 1, 2), 9: (3,)} if count == 1 else
                         {2: (0,), 5: (0, 1, 2), 9: (2, 3)})
