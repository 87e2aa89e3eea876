"""ADSR envelope.

Counterpart of ``oscen_tpu/nodes/envelope.py``: the reference's
gate-event-driven ADSR (envelope/adsr.rs) — one-pole exponential
attack/decay with coefficient ``1 - exp(-4.605/n)`` (99% at stage end, then
snap), linear release, velocity-scaled sustain and the zero-attack /
zero-release shortcuts.

The block path is the JAX package's segment-wise closed forms: gate events
split the block into segments, and each segment's levels are pure functions
of the absolute tick count since stage entry, so the output is bit-identical
across block sizes.  :class:`AdsrEnvelope` takes a leading instance axis
(``BATCHED``): state leaves ``[C]``, inputs ``[C, B]``, gate buffers
``[C, K]``.  The event offsets stay on the device (the segment loop runs
``K + 1`` times, ``K`` the buffer's host-known capacity).  The per-sample
kernel ``ops/cuda/adsr.py::adsr_scan`` is not wired in, as in the JAX
package.  :class:`AdsrBank` runs N envelopes that share one gate as
``C * N`` lanes of the same closed forms.
"""

from __future__ import annotations

import torch

from ..core.events import EventBuffer
from ..core.types import SampleRate, event, stream, value
from ..graph.node import Node, select_tree, tree_map
from ..ops import fmath

MIN_TIME_SECONDS = 1.0e-5
CURVE_TIME_CONSTANT = 4.6051702  # -ln(0.01)

IDLE, ATTACK, DECAY, SUSTAIN, RELEASE = range(5)

_I32 = torch.int32
_F32 = torch.float32


def _cached_steps(ins, sr_hz: float):
    """attack/decay/release stage lengths + one-pole coefficients
    (reference adsr.rs:117-134).  Pure function of this sample's params."""
    sr = max(float(sr_hz), 1.0)

    def n_samples(t):
        n = (torch.clamp_min(t, MIN_TIME_SECONDS) * sr).to(_I32)
        return torch.clamp_min(n, 1)
    a_n = n_samples(ins["attack"])
    d_n = n_samples(ins["decay"])
    r_n = n_samples(ins["release"])
    a_c = 1.0 - fmath.exp(fmath.rdiv(-CURVE_TIME_CONSTANT, a_n.to(_F32)))
    d_c = 1.0 - fmath.exp(fmath.rdiv(-CURVE_TIME_CONSTANT, d_n.to(_F32)))
    return a_n, d_n, r_n, a_c, d_c


def _release_increment(stage, rem, level):
    """Linear slope landing at zero (reference adsr.rs:160-173)."""
    current = torch.clamp(level, 0.0, 1.0)
    inc = torch.where(current <= 0.0, 0.0,
                      -current / torch.clamp_min(rem, 1).to(_F32))
    return torch.where((rem == 0) | (stage != RELEASE), 0.0, inc)


def _update_sustain_level(state, ins, velocity, sr_hz):
    """update_sustain_level (reference adsr.rs:92-115)."""
    sus = torch.clamp(ins["sustain"] * velocity, 0.0, 1.0)
    a_n, d_n, r_n, _, _ = _cached_steps(ins, sr_hz)
    stage = state["stage"]
    rem = state["rem"]
    has_rem = rem > 0
    cap = torch.where(stage == ATTACK, a_n,
                      torch.where(stage == DECAY, d_n,
                                  torch.where(stage == RELEASE, r_n, rem)))
    clamped = torch.clamp_min(torch.minimum(rem, cap), 1)
    in_timed = (stage == ATTACK) | (stage == DECAY) | (stage == RELEASE)
    rem = torch.where(in_timed & has_rem, clamped, rem)
    target = torch.where((stage == DECAY) | (stage == SUSTAIN), sus,
                         torch.where(stage == RELEASE, 0.0, state["target"]))
    # keep the absolute-time bookkeeping consistent: stage_len = age + rem
    # whenever rem was (possibly) clamped by a parameter change
    stage_len = torch.where(in_timed & has_rem, state["age"] + rem,
                            state["stage_len"])
    new = {**state, "sustain_level": sus, "velocity": velocity,
           "rem": rem, "target": target, "stage_len": stage_len}
    new["release_inc"] = torch.where(
        stage == RELEASE, _release_increment(stage, rem, state["level"]),
        state["release_inc"])
    return new


def _set_stage(state, ins, stage_code, target, sr_hz):
    """set_stage (reference adsr.rs:136-158).  Stage lengths are always
    >= 1 (recalculate forces max(1)), so the zero-sample recursion path is
    unreachable here; the zero-attack shortcut is handled in on_gate."""
    a_n, d_n, r_n, _, _ = _cached_steps(ins, sr_hz)
    samples = {ATTACK: a_n, DECAY: d_n, RELEASE: r_n}.get(
        stage_code, torch.zeros_like(a_n))
    stage = torch.full_like(state["stage"], stage_code)
    if isinstance(target, float):
        target = torch.full_like(state["level"], target)
    st = {**state, "stage": stage, "target": torch.clamp(target, 0.0, 1.0),
          "rem": samples, "entry_level": state["level"],
          "age": torch.zeros_like(state["age"]), "stage_len": samples}
    st["release_inc"] = _release_increment(stage, samples, st["level"])
    return st


class AdsrEnvelope(Node):
    INPUTS = (event("gate"), value("attack", 0.01), value("decay", 0.1),
              value("sustain", 0.7), value("release", 0.3))
    OUTPUTS = (stream("output"),)
    BATCHED = True

    def __init__(self, attack: float = 0.01, decay: float = 0.1,
                 sustain: float = 0.7, release: float = 0.3):
        self.INPUTS = (event("gate"),
                       value("attack", float(attack)),
                       value("decay", float(decay)),
                       value("sustain", float(sustain)),
                       value("release", float(release)))
        self._sustain0 = float(min(max(sustain, 0.0), 1.0))

    def init_state(self, sr: SampleRate):
        def f(x):
            return torch.tensor(x, dtype=_F32)

        def i(x):
            return torch.tensor(x, dtype=_I32)
        return {
            "stage": i(IDLE), "rem": i(0), "level": f(0.0),
            "target": f(0.0), "sustain_level": f(self._sustain0),
            "velocity": f(1.0), "release_inc": f(0.0),
            # absolute-time bookkeeping for the block-mode closed forms:
            # level at stage entry, ticks since stage entry, stage length
            "entry_level": f(0.0), "age": i(0), "stage_len": i(0),
        }

    # ------------------------------------------------------------------ #
    def on_gate(self, state, velocity, sr, ins):
        """handle_gate_event (reference adsr.rs:250-273); ``velocity`` and
        every state leaf and parameter are ``[C]``."""
        sr_hz = sr.hz

        # --- gate ON path ---
        vel = torch.clamp(velocity, 0.0, 1.0)
        on = _update_sustain_level(state, ins, vel, sr_hz)
        # zero-attack shortcut: level=1, straight to decay
        shortcut = {**on, "level": torch.ones_like(on["level"])}
        shortcut = _set_stage(shortcut, ins, DECAY, on["sustain_level"],
                              sr_hz)
        normal = _set_stage(on, ins, ATTACK, 1.0, sr_hz)
        on_state = select_tree(ins["attack"] <= MIN_TIME_SECONDS, shortcut,
                               normal)

        # --- gate OFF path ---
        zi = torch.zeros_like(state["stage"])
        zf = torch.zeros_like(state["level"])
        idle = {**state, "stage": zi, "level": zf, "rem": zi,
                "release_inc": zf, "entry_level": zf, "age": zi,
                "stage_len": zi}
        rel = _set_stage(state, ins, RELEASE, 0.0, sr_hz)
        off_state = select_tree(ins["release"] <= MIN_TIME_SECONDS, idle,
                                rel)

        return select_tree(velocity > 0.0, on_state, off_state)

    # ------------------------------------------------------------------ #
    def tick(self, state, ins, sr):
        """One sample of the reference's state machine (adsr.rs), every
        branch computed and selected, in the JAX package's order."""
        sr_hz = sr.hz
        # apply_parameters (reference adsr.rs:84-90): clamp params, then
        # update_sustain_level with the *current* velocity
        params = {**ins,
                  "attack": torch.clamp_min(ins["attack"], 0.0),
                  "decay": torch.clamp_min(ins["decay"], 0.0),
                  "sustain": torch.clamp(ins["sustain"], 0.0, 1.0),
                  "release": torch.clamp_min(ins["release"], 0.0)}
        st = _update_sustain_level(state, params, state["velocity"], sr_hz)
        a_n, d_n, r_n, a_c, d_c = _cached_steps(params, sr_hz)
        stage, rem, level = st["stage"], st["rem"], st["level"]
        sus = st["sustain_level"]

        def stepping(code):
            active = (stage == code) & (rem > 0)
            done = (stage == code) & (torch.where(rem > 0, rem - 1, rem)
                                      == 0)
            return active, done
        att_active, att_done = stepping(ATTACK)
        dec_active, dec_done = stepping(DECAY)
        rel_active, rel_done = stepping(RELEASE)
        att_level = torch.clamp(level + (1.0 - level) * a_c, 0.0, 1.0)
        dec_level = torch.clamp(level + (sus - level) * d_c, 0.0, 1.0)
        rel_level = torch.clamp(level + st["release_inc"], 0.0, 1.0)

        level = torch.where(att_active, att_level,
                 torch.where(dec_active, dec_level,
                  torch.where(rel_active, rel_level,
                   torch.where(stage == SUSTAIN, sus,
                    torch.where(stage == IDLE, 0.0, level)))))
        stepped = att_active | dec_active | rel_active
        rem = torch.where(stepped, rem - 1, rem)

        # completions (reference complete_stage, adsr.rs:175-204); attack
        # completion chains into set_stage(Decay, sustain)
        level = torch.where(att_done, 1.0, level)
        level = torch.where(dec_done, sus, level)
        level = torch.where(rel_done, 0.0, level)
        new_stage = torch.where(att_done, DECAY,
                     torch.where(dec_done, SUSTAIN,
                      torch.where(rel_done, IDLE, stage))).to(_I32)
        dec_or_rel = dec_done | rel_done
        any_done = att_done | dec_or_rel
        rem = torch.where(att_done, d_n, torch.where(dec_or_rel, 0, rem))
        release_inc = torch.where(any_done, 0.0, st["release_inc"])
        target = torch.where(att_done, torch.clamp(sus, 0.0, 1.0),
                             st["target"])

        # absolute-time bookkeeping (used by the block-mode closed forms)
        age = torch.where(stepped, st["age"] + 1, st["age"])
        age = torch.where(any_done, 0, age).to(_I32)
        entry = torch.where(att_done, 1.0,
                 torch.where(dec_done, sus,
                  torch.where(rel_done, 0.0, st["entry_level"])))
        stage_len = torch.where(att_done, d_n,
                                torch.where(dec_or_rel, 0,
                                            st["stage_len"])).to(_I32)
        return ({**st, "stage": new_stage, "rem": rem.to(_I32),
                 "level": level, "target": target,
                 "release_inc": release_inc, "entry_level": entry,
                 "age": age, "stage_len": stage_len},
                {"output": level})

    # ------------------------------------------------------------------ #
    # block mode: segment-wise closed forms
    # ------------------------------------------------------------------ #
    def process_block(self, state, ins, events, sr, block_len):
        """Closed-form evaluation: the one-pole attack/decay and linear
        release telescope to exact exponentials/lines, so the whole block
        evaluates in O(1) depth.  Gate events split the block into K+1
        segments with per-voice boundaries handled by per-sample masking.

        Assumes block-constant ADSR parameters for the stage-length math
        (values at each segment start); the sustain level itself follows
        per-sample parameter changes.
        """
        B = block_len
        buf = events.get("gate")
        k_events = buf.capacity if buf is not None else 0
        dev = state["level"].device
        t_idx = torch.arange(B, dtype=_F32, device=dev)

        def pw(one_minus_c, e):
            # (1-c)^e via exp/log; c<1 guaranteed by construction
            return fmath.exp(e * fmath.log(torch.clamp_min(one_minus_c,
                                                           1e-30)))

        def seg_params(off):
            """Params at a per-voice sample offset ``off`` ``[C]``: one
            gather along time."""
            idx = torch.clamp(off, 0, B - 1).long()[:, None]
            return {k: torch.gather(v, 1, idx)[:, 0] for k, v in ins.items()}

        def consts(p):
            a_n, d_n, r_n, a_c, d_c = _cached_steps(
                {k: torch.clamp_min(v, 0.0) if k != "sustain"
                 else torch.clamp(v, 0.0, 1.0) for k, v in p.items()}, sr.hz)
            return a_n.to(_F32), d_n.to(_F32), r_n.to(_F32), a_c, d_c

        def seg_levels(st, p, k):
            """Level after k+1 ticks into the segment; ``k`` is ``[C]`` or
            ``[C, B]`` (negative values are masked by the caller).

            Stage-entry-based: pure functions of the absolute tick count
            since stage entry (``age + k + 1``) and the level at stage
            entry, so the same absolute sample gives the bit-identical
            level wherever block and segment boundaries fall."""
            if k.dim() == 2:
                st = {key: v[:, None] for key, v in st.items()}
                p = {key: v[:, None] for key, v in p.items()}
            a_n, d_n, r_n, a_c, d_c = consts(p)
            sus = torch.clamp(p["sustain"] * st["velocity"], 0.0, 1.0)
            ln = torch.clamp_min(st["stage_len"].to(_F32), 0.0)
            entry = st["entry_level"]
            tau = (st["age"].to(_F32) + k) + 1.0
            stage = st["stage"]

            # ATTACK: toward 1, snap at stage end; then DECAY for d_n; SUS
            att = 1.0 - (1.0 - entry) * pw(1.0 - a_c, tau)
            att = torch.where(tau >= ln, 1.0, att)
            u = tau - ln  # decay steps after attack end (entry level 1.0)
            # one decay power sweep serves both the post-attack decay and
            # the DECAY stage (exponent selected per stage)
            pd = pw(1.0 - d_c, torch.where(stage == ATTACK, u, tau))
            att_dec = sus + (1.0 - sus) * pd
            att_dec = torch.where(u >= d_n, sus, att_dec)
            attack_lv = torch.where(tau <= ln, att,
                                    torch.where(u <= d_n, att_dec, sus))

            # DECAY: toward sus, snap at stage end; then SUSTAIN
            dec = sus + (entry - sus) * pd
            decay_lv = torch.where(tau >= ln, sus, dec)

            # RELEASE: linear from entry level to 0 over the stage length
            rel = entry * torch.clamp_min(ln - tau, 0.0) \
                / torch.clamp_min(ln, 1.0)
            release_lv = torch.where(tau >= ln, 0.0, rel)

            lv = torch.where(
                stage == ATTACK, attack_lv,
                torch.where(stage == DECAY, decay_lv,
                            torch.where(stage == RELEASE, release_lv,
                                        torch.where(stage == SUSTAIN, sus,
                                                    0.0))))
            return torch.clamp(lv, 0.0, 1.0)

        def seg_end_state(st, p, n):
            """State after ``n`` ``[C]`` ticks (n >= 0).  All stage
            bookkeeping is exact int32 arithmetic on absolute positions."""
            a_n, d_n, r_n, a_c, d_c = consts(p)
            d_ni = d_n.to(_I32)
            sus = torch.clamp(p["sustain"] * st["velocity"], 0.0, 1.0)
            ln = st["stage_len"]
            nf = n.to(_F32)
            lvl_end = torch.where(nf > 0, seg_levels(st, p, nf - 1.0),
                                  st["level"])
            stage = st["stage"]
            tau_end = st["age"] + n  # int32, exact

            in_stage = tau_end < ln
            att_in_decay = (tau_end >= ln) & (tau_end - ln < d_ni)
            timed_in = ((stage == DECAY) | (stage == RELEASE)) & in_stage
            new_stage = torch.where(
                stage == ATTACK,
                torch.where(in_stage, ATTACK,
                            torch.where(att_in_decay, DECAY, SUSTAIN)),
                torch.where(
                    stage == DECAY,
                    torch.where(in_stage, DECAY, SUSTAIN),
                    torch.where(stage == RELEASE,
                                torch.where(in_stage, RELEASE, IDLE),
                                stage))).to(_I32)
            new_age = torch.where(
                stage == ATTACK,
                torch.where(in_stage, tau_end,
                            torch.where(att_in_decay, tau_end - ln, 0)),
                torch.where(timed_in, tau_end, 0)).to(_I32)
            new_len = torch.where(
                stage == ATTACK,
                torch.where(in_stage, ln, torch.where(att_in_decay, d_ni, 0)),
                torch.where(timed_in, ln, 0)).to(_I32)
            new_entry = torch.where(
                (stage == ATTACK) & att_in_decay, 1.0,
                torch.where(new_stage == SUSTAIN, sus,
                            torch.where(new_stage == IDLE, 0.0,
                                        st["entry_level"])))
            new_rem = torch.clamp_min(new_len - new_age, 0).to(_I32)
            new_state = {
                **st, "stage": new_stage, "rem": new_rem, "level": lvl_end,
                "sustain_level": sus, "entry_level": new_entry,
                "age": new_age, "stage_len": new_len,
                "target": torch.where(
                    new_stage == RELEASE, 0.0,
                    torch.where(new_stage >= DECAY, sus, st["target"]))}
            new_state["release_inc"] = _release_increment(
                new_stage, new_rem, lvl_end)
            return select_tree(n > 0, new_state, st)

        C = state["level"].shape[0]
        levels = torch.zeros((C, B), dtype=_F32, device=dev)
        st = state
        start = torch.zeros((C,), dtype=_I32, device=dev)
        for j in range(k_events + 1):
            if j < k_events:
                end = torch.where(buf.valid[:, j],
                                  torch.clamp(buf.offsets[:, j], 0, B),
                                  B).to(_I32)
            else:
                end = torch.full((C,), B, dtype=_I32, device=dev)
            p = seg_params(start)
            k_rel = t_idx[None, :] - start.to(_F32)[:, None]
            lv = seg_levels(st, p, k_rel)
            mask = (t_idx[None, :] >= start[:, None]) \
                & (t_idx[None, :] < end[:, None])
            levels = torch.where(mask, lv, levels)
            st = seg_end_state(st, p, end - start)
            if j < k_events:
                p_ev = seg_params(end)
                fired = buf.valid[:, j] & (buf.offsets[:, j] < B)
                st = select_tree(
                    fired, self.on_gate(st, buf.values[:, j], sr, p_ev), st)
                start = end
        return st, {"output": levels}


class AdsrBank(Node):
    """N ADSR envelopes sharing one gate, fused into one node (the fm and
    pivot voices run four: op3, op2, op1 and the filter; fm_voice.rs:54-63).

    Semantics are exactly N independent :class:`AdsrEnvelope`s; each
    section has its own ``<section>_<param>`` inputs and its own stream
    output named after it.  State leaves are ``[N]`` per instance
    (``[C, N]`` for a node array), as the JAX package stacks them, and a
    node array of C banks evaluates as ``C * N`` envelope lanes in one
    :meth:`AdsrEnvelope.process_block`, every lane reading its instance's
    gate buffer.
    """

    BATCHED = True
    _PARAMS = ("attack", "decay", "sustain", "release")

    def __init__(self, sections):
        """``sections``: iterable of (name, attack, decay, sustain,
        release)."""
        sections = list(sections)
        if not sections:
            raise ValueError("AdsrBank needs at least one section")
        self._names = [s[0] for s in sections]
        if len(set(self._names)) != len(self._names):
            raise ValueError("duplicate section names")
        self._subs = [AdsrEnvelope(a, d, s_, r)
                      for (_, a, d, s_, r) in sections]
        ins = [event("gate")]
        for (name, a, d, s_, r) in sections:
            ins += [value(f"{name}_attack", float(a)),
                    value(f"{name}_decay", float(d)),
                    value(f"{name}_sustain", float(s_)),
                    value(f"{name}_release", float(r))]
        self.INPUTS = tuple(ins)
        self.OUTPUTS = tuple(stream(n) for n in self._names)

    def init_state(self, sr: SampleRate):
        states = [sub.init_state(sr) for sub in self._subs]
        return tree_map(lambda *xs: torch.stack(xs), *states)

    def _stack_ins(self, ins):
        """Each parameter's sections stacked on a trailing axis, as the
        state's ``[(C,) N]`` leaves."""
        return {p: torch.stack([ins[f"{n}_{p}"] for n in self._names],
                               dim=-1)
                for p in self._PARAMS}

    def on_gate(self, state, velocity, sr, ins):
        return self._subs[0].on_gate(state, velocity[..., None], sr,
                                     self._stack_ins(ins))

    def tick(self, state, ins, sr):
        st, outs = self._subs[0].tick(state, self._stack_ins(ins), sr)
        lv = outs["output"]
        return st, {n: lv[..., i] for i, n in enumerate(self._names)}

    def process_block(self, state, ins, events, sr, block_len):
        N = len(self._names)
        C = state["level"].shape[0]
        lanes = tree_map(lambda x: x.reshape(C * N), state)
        lane_ins = {p: torch.stack([ins[f"{n}_{p}"] for n in self._names],
                                   dim=1).reshape(C * N, block_len)
                    for p in self._PARAMS}
        lane_evs = {k: EventBuffer(*(torch.repeat_interleave(x, N, dim=0)
                                     for x in (b.offsets, b.values,
                                               b.valid)))
                    for k, b in events.items()}
        st, outs = self._subs[0].process_block(lanes, lane_ins, lane_evs, sr,
                                               block_len)
        lv = outs["output"].reshape(C, N, block_len)
        return (tree_map(lambda x: x.reshape(C, N), st),
                {n: lv[:, i] for i, n in enumerate(self._names)})
