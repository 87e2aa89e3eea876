"""FM synth voice — multi-operator FM with ADSR envelopes and routing.

Counterpart of ``oscen_tpu/models/fm_synth.py``: the reference example's
FMVoice graph (examples/fm-synth/src/fm_voice.rs:6-157), three FmOperators
(OP3 → OP2 → OP1 carrier, with a crossfaded OP3→OP1 route), per-operator
ADSR envelopes, a filter envelope with cutoff modulation, a TPT filter and
an output gain.  ``build_fm_synth`` wraps N voices behind MIDI and voice
allocation.
"""

from __future__ import annotations

import torch

from ..core.types import SampleRate, stream, value
from ..graph import explain
from ..graph.builder import Graph
from ..graph.node import Node
from ..nodes.basic import AddValue, Crossfade, FmOperator, Gain, Mixer
from ..nodes.envelope import AdsrBank, AdsrEnvelope
from ..nodes.filters import TptFilter
from ..nodes.midi import MidiParser, MidiVoiceHandler
from ..nodes.voice_allocator import VoiceAllocator
from ..ops import fmath
from ..ops.cuda.fm import fast_branch_eligible, fm_chain3_scan
from ..ops.fastmath import sin_turns, sin_turns_fma

FB_EPS = ("op3_feedback", "op2_feedback", "op1_feedback")
DT_EPS = frozenset({"base_freq", "op3_ratio", "op2_ratio", "op1_ratio"})


def chain_block(kernel, scan, lvl, state, ins, sr, block_len, const_ins,
                literal_ins, host_ins):
    """One block of a fused 3-operator chain node (fm or pivot) for all
    instances: ``state`` leaves ``[C, 3]``, ``ins`` ``[C, B]``, ``lvl``
    the ``[3, C]`` operator levels.

    dt is per-sample ``[3, B, C]`` when the voice allocator retunes
    ``base_freq`` mid-block at a note-on; in blocks where it and the ratios
    are block-constant (``const_ins``) it collapses to ``[3, 1, C]`` rows.
    Levels, feedbacks and the route are hoisted from sample 0.  The
    zero-feedback branch is chosen on the host: from the feedbacks'
    literal values, else from their host-known values when they are live
    block-constant graph parameters; in every other case (feedback fed from
    the card, a ramping parameter) the sequential kernel runs.
    """
    dt_const = DT_EPS <= const_ins
    freq = [ins["base_freq"] * ins[f"op{i}_ratio"] for i in (3, 2, 1)]
    if dt_const:
        freq = [f[:, :1] for f in freq]
    # base_freq*ratio/sr as XLA compiles the JAX package's graph: the
    # product times the float32 reciprocal, rounded (fm) or contracted
    # into the phase's sum (the pivot: fma(f*ratio, 1/sr, phase))
    dt = torch.stack([f.t() for f in freq])
    inv = fmath.inv_const(sr.hz)
    if kernel != "pivot_chain3":
        dt, inv = dt * inv, 1.0
    fb = torch.stack([ins[ep][:, 0] for ep in FB_EPS])
    mix = torch.clamp(ins["route"][:, 0], 0.0, 1.0)
    lits = literal_ins or {}
    fb_static = (all(lits[ep] == 0.0 for ep in FB_EPS)
                 if all(ep in lits for ep in FB_EPS) else None)
    hv = host_ins or {}
    fb_zero = fb_static if fb_static is not None else (
        all(ep in hv for ep in FB_EPS) and all(hv[ep] == 0.0 for ep in FB_EPS))
    eligible = fast_branch_eligible(dt, block_len, kernel == "pivot_chain3")
    explain.note(kernel=kernel, const_dt=dt_const, fast_path="zero_feedback",
                 eligible=eligible, engaged=eligible and fb_zero,
                 predicate="all_zero" if (eligible and fb_static is None)
                 else None, predicate_eps=FB_EPS)
    y, ph, pv = scan(state["phases"].t().contiguous(),
                     state["prevs"].t().contiguous(), dt, lvl.contiguous(),
                     fb.contiguous(), mix.contiguous(),
                     ins["env3"].t(), ins["env2"].t(), ins["env1"].t(),
                     fb_zero=fb_zero, inv_sr=inv)
    return ({"phases": ph.t(), "prevs": pv.t()}, {"output": y.t()})


def chain_tick(pivot: bool, state, ins, sr, lvl):
    """One sample of a fused 3-operator chain (the JAX package's ``tick``)
    in the order of the chain kernel's plain version (``ops/cuda/fm.py``):
    each operator's sine at ``(phase + pm) + prev*fb``, its phase stepped
    by ``base_freq*ratio/sr`` and wrapped by ``.fract()``.  The pivot
    rounds as XLA compiles its tick: each product into a sum is one fused
    multiply-add (the phase step ``fma(base_freq*ratio, 1/sr, phase)``,
    the sine :func:`sin_turns_fma`); the fm chain rounds each op.
    ``prevs`` carries the enveloped outputs (fm) or the raw sines (pivot);
    ``lvl`` are the three operator levels, folded into the envelopes as the
    kernel does.  State leaves ``[(C,) 3]``, inputs ``[(C,)]``."""
    ph, pv = state["phases"], state["prevs"]
    mix = torch.clamp(ins["route"], 0.0, 1.0)
    inv = fmath.inv_const(sr.hz)
    madd = fmath.fma if pivot else (lambda a, b, c: c + a * b)
    sine = sin_turns_fma if pivot else sin_turns
    env = [ins[f"env{i}"] * lv for i, lv in zip((3, 2, 1), lvl)]
    sines, outs, phases = [], [], []
    for j, i in enumerate((3, 2, 1)):
        if j == 0:
            arg = ph[..., 0]
        elif j == 1:
            arg = madd(outs[0], 1.0 - mix, ph[..., 1])
        else:
            arg = ph[..., 2] + madd(outs[0], mix, outs[1])
        s = sine(madd(pv[..., j], ins[f"op{i}_feedback"], arg))
        fr = ins["base_freq"] * ins[f"op{i}_ratio"]
        p = (fmath.fma(fr, inv, ph[..., j]) if pivot
             else ph[..., j] + fmath.div_const(fr, sr.hz))
        phases.append(p - torch.trunc(p))
        sines.append(s)
        outs.append(s * env[j])
    return ({"phases": torch.stack(phases, dim=-1),
             "prevs": torch.stack(sines if pivot else outs, dim=-1)},
            {"output": outs[2]})


class FmOperatorChain(Node):
    """The FMVoice operator section fused into one node: op3 → route
    crossfade → op2 → mixer → op1 (fm_voice.rs connections :119-147), each
    an FM operator with self-feedback; one ``fm_chain3_scan`` per block for
    all voices (the kernel on the card).  Takes a leading instance axis
    (``BATCHED``): state ``phases``/``prevs`` ``[C, 3]``, inputs
    ``[C, B]``."""

    INPUTS = (value("base_freq", 440.0),
              value("op3_ratio", 3.0), value("op2_ratio", 2.0),
              value("op1_ratio", 1.0),
              value("op3_level", 0.5), value("op2_level", 0.5),
              value("op1_level", 1.0),
              value("op3_feedback", 0.0), value("op2_feedback", 0.0),
              value("op1_feedback", 0.0),
              value("route", 0.0),
              stream("env3", 1.0), stream("env2", 1.0),
              stream("env1", 1.0))
    OUTPUTS = (stream("output"),)
    BATCHED = True
    FB_EPS = FB_EPS

    def init_state(self, sr: SampleRate):
        return {"phases": torch.zeros((3,), dtype=torch.float32),
                "prevs": torch.zeros((3,), dtype=torch.float32)}

    def tick(self, state, ins, sr):
        return chain_tick(False, state, ins, sr,
                          [ins[f"op{i}_level"] for i in (3, 2, 1)])

    def process_block(self, state, ins, events, sr, block_len,
                      const_ins=frozenset(), literal_ins=None,
                      host_ins=None):
        lvl = torch.stack([ins[f"op{i}_level"][:, 0] for i in (3, 2, 1)])
        return chain_block("fm_chain3", fm_chain3_scan, lvl, state, ins, sr,
                           block_len, const_ins, literal_ins, host_ins)

    def process_block_batched(self, state, ins, events, sr, block_len,
                              const_ins=frozenset(), literal_ins=None,
                              host_ins=None):
        return self.process_block(state, ins, events, sr, block_len,
                                  const_ins, literal_ins, host_ins)


OP_DEFAULTS = {
    "op3": dict(ratio=3.0, level=0.5, feedback=0.0, attack=0.01,
                decay=0.1, sustain=0.7, release=0.3),
    "op2": dict(ratio=2.0, level=0.5, feedback=0.0, attack=0.01,
                decay=0.1, sustain=0.7, release=0.3),
    "op1": dict(ratio=1.0, attack=0.01, decay=0.2, sustain=0.8,
                release=0.5),
}
FILTER_ENV = dict(attack=0.01, decay=0.2, sustain=0.5, release=0.3)


def _voice_inputs(g: Graph) -> None:
    g.input("frequency", "value", default=440.0)
    g.input("gate", "event")
    for op, d in OP_DEFAULTS.items():
        for k, v in d.items():
            g.input(f"{op}_{k}", "value", default=v)
    g.input("route", "value", default=0.0)
    g.input("filter_cutoff", "value", default=2000.0)
    g.input("filter_resonance", "value", default=0.707)
    for k, v in FILTER_ENV.items():
        g.input(f"filter_{k}", "value", default=v)
    g.input("filter_env_amount", "value", default=0.0)
    g.output("audio_out", "stream")


def build_fm_voice(fused: bool = False) -> Graph:
    """``fused=True`` collapses the operator section into the
    FmOperatorChain node and the envelopes into an AdsrBank;
    ``fused=False`` mirrors the reference graph node for node."""
    if fused:
        return _build_fm_voice_fused()
    g = Graph("FMVoice")
    _voice_inputs(g)

    env3 = g.add("env3", AdsrEnvelope(0.01, 0.1, 0.7, 0.3))
    env2 = g.add("env2", AdsrEnvelope(0.01, 0.1, 0.7, 0.3))
    env1 = g.add("env1", AdsrEnvelope(0.01, 0.2, 0.8, 0.5))
    env_f = g.add("env_filter", AdsrEnvelope(0.01, 0.2, 0.5, 0.3))
    f_gain = g.add("filter_env_gain", Gain(0.0))
    cutoff_mod = g.add("cutoff_mod", AddValue(2000.0))
    op3 = g.add("op3_osc", FmOperator())
    op2 = g.add("op2_osc", FmOperator())
    op1 = g.add("op1_osc", FmOperator())
    route = g.add("op3_route", Crossfade())
    mix1 = g.add("op1_mod_mixer", Mixer())
    filt = g.add("filter", TptFilter(2000.0, 0.707))
    out_g = g.add("output_gain", Gain(0.3))

    # gate to all envelopes; per-operator envelope parameters
    for env in (env3, env2, env1):
        g.connect("gate", env.gate)
    g.connect("gate", env_f.gate)
    for env_name, op in (("env3", "op3"), ("env2", "op2"), ("env1", "op1")):
        for k in ("attack", "decay", "sustain", "release"):
            g.connect(f"{op}_{k}", f"{env_name}.{k}")
    for k in ("attack", "decay", "sustain", "release"):
        g.connect(f"filter_{k}", f"env_filter.{k}")

    # filter envelope modulation: env -> gain(amount) -> add(cutoff)
    g.connect(env_f.output, f_gain.input)
    g.connect("filter_env_amount", f_gain.gain)
    g.connect(f_gain.output, cutoff_mod.input)
    g.connect("filter_cutoff", cutoff_mod.value)
    g.connect(cutoff_mod.output, filt.cutoff)

    # OP3 (top modulator)
    g.connect("frequency", op3.base_freq)
    g.connect("op3_ratio", op3.ratio)
    g.connect("op3_feedback", op3.feedback)
    g.connect(env3.output, op3.envelope)
    g.connect("op3_level", op3.level)

    # route crossfade: OP3 -> OP2 (a) or OP1 (b)
    g.connect(op3.output, route.input)
    g.connect("route", route.mix)
    g.connect(route.output_a, op2.phase_mod)

    # OP2 (middle modulator)
    g.connect("frequency", op2.base_freq)
    g.connect("op2_ratio", op2.ratio)
    g.connect("op2_feedback", op2.feedback)
    g.connect(env2.output, op2.envelope)
    g.connect("op2_level", op2.level)

    # mix OP2 + routed OP3 into OP1's phase mod
    g.connect(op2.output, mix1.input_a)
    g.connect(route.output_b, mix1.input_b)
    g.connect(mix1.output, op1.phase_mod)

    # OP1 (carrier)
    g.connect("frequency", op1.base_freq)
    g.connect("op1_ratio", op1.ratio)
    g.connect(env1.output, op1.envelope)
    g.connect(op1.output, filt.input)

    g.connect("filter_resonance", filt.q)
    g.connect(filt.output, out_g.input)
    g.connect(out_g.output, "audio_out")
    return g


def _build_fm_voice_fused() -> Graph:
    g = Graph("FMVoiceFused")
    _voice_inputs(g)

    # the four per-voice envelopes fused into one node
    envs = g.add("envs", AdsrBank([
        ("op3", 0.01, 0.1, 0.7, 0.3),
        ("op2", 0.01, 0.1, 0.7, 0.3),
        ("op1", 0.01, 0.2, 0.8, 0.5),
        ("filt", 0.01, 0.2, 0.5, 0.3),
    ]))
    f_gain = g.add("filter_env_gain", Gain(0.0))
    cutoff_mod = g.add("cutoff_mod", AddValue(2000.0))
    chain = g.add("ops", FmOperatorChain())
    filt = g.add("filter", TptFilter(2000.0, 0.707))
    out_g = g.add("output_gain", Gain(0.3))

    g.connect("gate", envs.gate)
    for op in ("op3", "op2", "op1"):
        for k in ("attack", "decay", "sustain", "release"):
            g.connect(f"{op}_{k}", f"envs.{op}_{k}")
    for k in ("attack", "decay", "sustain", "release"):
        g.connect(f"filter_{k}", f"envs.filt_{k}")

    g.connect(envs.filt, f_gain.input)
    g.connect("filter_env_amount", f_gain.gain)
    g.connect(f_gain.output, cutoff_mod.input)
    g.connect("filter_cutoff", cutoff_mod.value)
    g.connect(cutoff_mod.output, filt.cutoff)

    g.connect("frequency", chain.base_freq)
    for i in (3, 2):
        g.connect(f"op{i}_ratio", f"ops.op{i}_ratio")
        g.connect(f"op{i}_level", f"ops.op{i}_level")
        g.connect(f"op{i}_feedback", f"ops.op{i}_feedback")
    g.connect("op1_ratio", chain.op1_ratio)
    g.connect("route", chain.route)
    g.connect(envs.op3, chain.env3)
    g.connect(envs.op2, chain.env2)
    g.connect(envs.op1, chain.env1)

    g.connect(chain.output, filt.input)
    g.connect("filter_resonance", filt.q)
    g.connect(filt.output, out_g.input)
    g.connect(out_g.output, "audio_out")
    return g


def build_fm_synth(num_voices: int = 8, fused: bool = True) -> Graph:
    """Polyphonic FM synth: MIDI → allocator → N FMVoice subgraphs →
    fan-in mix (the reference app runs 8 voices)."""
    g = Graph(f"FMSynth{num_voices}")
    g.input("midi_in", "event")
    g.input("route", "value", default=0.0)
    g.input("filter_cutoff", "value", default=2000.0)
    g.output("audio_out", "stream")

    parser = g.add("parser", MidiParser())
    alloc = g.add("alloc", VoiceAllocator(num_voices))
    handlers = g.add("handlers", MidiVoiceHandler(), count=num_voices)
    voices = g.add("voices", build_fm_voice(fused=fused),
                   count=num_voices)

    g.connect("midi_in", parser.midi_in)
    g.connect(parser.note_on, alloc.note_on)
    g.connect(parser.note_off, alloc.note_off)
    g.connect(alloc.voices, handlers.note_on)
    g.connect(alloc.voices, handlers.note_off)
    g.connect(handlers.frequency, voices.frequency)
    g.connect(handlers.gate, voices.gate)
    g.connect("route", voices.route)
    g.connect("filter_cutoff", voices.filter_cutoff)
    g.connect(voices.audio_out, "audio_out")
    return g
