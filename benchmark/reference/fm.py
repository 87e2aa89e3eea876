"""Plain reference of the FM synth: oscen's ``examples/fm-synth``
(``fm_voice.rs``, ``envelope/adsr.rs``, ``filters/tpt/mod.rs``) sample by
sample, in float64 (or in the precision asked for), with no kernel and no
closed form.

A voice is three sine operators, op3 -> op2 -> op1, each with its own ADSR
envelope times its level; op3's output is added to op2's phase (route 0
sends all of it there), op2's to op1's, in turns.  Each operator's phase
steps by frequency * ratio / rate and wraps to [0, 1).  The carrier op1
goes through a topology-preserving state-variable lowpass at the cutoff and
Q of the patch and a gain, and the voices are summed.  The ADSR is the
published state machine: a one-pole attack toward 1 and decay toward the
velocity-scaled sustain, each reaching 99% at its stage's end and snapping
there, a linear release to 0; a note-on restarts the attack from the level
where it is, a note-off starts the release from there.  Stage lengths are
whole samples, ``(seconds * rate) as usize`` in float32 as the published
code computes them.  The fourth envelope (the filter's) moves the cutoff
by ``filter_env_amount``, which the patch holds at 0, so this reference
steps it and keeps the cutoff fixed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

IDLE, ATTACK, DECAY, SUSTAIN, RELEASE = range(5)
CURVE = 4.6051702          # -ln(0.01): 99% at the stage's end
SECTIONS = ("op3", "op2", "op1", "filt")


def stage_samples(seconds: float, sr: float) -> int:
    """``(max(t, 1e-5) * sr) as usize``, at least 1, in float32."""
    t = max(np.float32(seconds), np.float32(1e-5))
    return max(1, int(np.float32(t) * np.float32(sr)))


class FmSynth:
    def __init__(self, voices: int, sample_rate: float, patch: dict,
                 dtype=torch.float64):
        self.V, self.sr, self.p, self.dt = voices, sample_rate, patch, dtype
        f = lambda x: torch.tensor(x, dtype=dtype)   # noqa: E731
        env = [patch["envelopes"][s] for s in SECTIONS]
        self.a_n = torch.tensor([stage_samples(e["attack"], sample_rate)
                                 for e in env])
        self.d_n = torch.tensor([stage_samples(e["decay"], sample_rate)
                                 for e in env])
        self.r_n = torch.tensor([stage_samples(e["release"], sample_rate)
                                 for e in env])
        self.a_c = f([1.0 - math.exp(-CURVE / n) for n in self.a_n.tolist()])
        self.d_c = f([1.0 - math.exp(-CURVE / n) for n in self.d_n.tolist()])
        self.sustain = f([e["sustain"] for e in env])
        ops = patch["operators"]
        self.ratio = f([ops[o]["ratio"] for o in SECTIONS[:3]])
        self.level = f([ops[o]["level"] for o in SECTIONS[:3]])
        self.feedback = f([ops[o]["feedback"] for o in SECTIONS[:3]])
        self.route = min(max(patch["route"], 0.0), 1.0)
        if patch["filter_env_amount"] != 0.0:
            raise ValueError("this reference holds the cutoff fixed: "
                             "filter_env_amount must be 0")
        # the lowpass's coefficients at the fixed cutoff and Q
        cutoff = min(max(patch["filter_cutoff"], 20.0),
                     min(sample_rate * 0.5, 20000.0))
        g = math.tan(math.pi * cutoff / sample_rate)
        r = 1.0 / min(max(patch["filter_resonance"], 0.1), 10.0)
        self.h, self.g, self.k = 1.0 / (1.0 + r * g + g * g), g, g + r
        self.gain = patch["output_gain"]

    # ------------------------------------------------------------------
    def init_state(self, freqs) -> dict:
        V = self.V
        return {"stage": torch.zeros((V, 4), dtype=torch.int64),
                "rem": torch.zeros((V, 4), dtype=torch.int64),
                "level": torch.zeros((V, 4), dtype=self.dt),
                "velocity": torch.ones((V, 4), dtype=self.dt),
                "phases": torch.zeros((V, 3), dtype=self.dt),
                "prevs": torch.zeros((V, 3), dtype=self.dt),
                "z0": torch.zeros(V, dtype=self.dt),
                "z1": torch.zeros(V, dtype=self.dt),
                "freq": torch.tensor(freqs, dtype=self.dt)}

    def _program(self, state: dict) -> dict:
        e, o, fl = (state["voices.envs"], state["voices.ops"],
                    state["voices.filter"])
        d = lambda x: torch.as_tensor(x).to(torch.float64)  # noqa: E731
        i = lambda x: torch.as_tensor(x).to(torch.int64)    # noqa: E731
        return {"stage": i(e["stage"]), "rem": i(e["rem"]),
                "level": d(e["level"]), "velocity": d(e["velocity"]),
                "phases": d(o["phases"]), "prevs": d(o["prevs"]),
                "z0": d(fl["z0"]), "z1": d(fl["z1"])}

    def from_program(self, state: dict, freqs) -> dict:
        """The reference's state from the program's at a block boundary:
        the envelopes' stages, counts and levels, the operators' phases
        and last outputs, the filter's two integrators; each voice's
        frequency is the reference's own."""
        s = self._program(state)
        for k in ("level", "velocity", "phases", "prevs", "z0", "z1"):
            s[k] = s[k].to(self.dt)
        s["freq"] = torch.tensor(freqs, dtype=self.dt)
        return s

    def program_view(self, state: dict) -> dict:
        return self._program(state)

    PHASES = ("phases",)
    COMPARED = ("stage", "rem", "level", "phases", "z0", "z1")

    # ------------------------------------------------------------------
    def _gate(self, s, v: int, g: float) -> None:
        if g > 0.0:
            vel = min(max(g, 0.0), 1.0)
            s["velocity"][v] = vel
            s["stage"][v] = ATTACK
            s["rem"][v] = self.a_n
        else:
            s["stage"][v] = RELEASE
            s["rem"][v] = self.r_n

    def _envelopes(self, s):
        """One sample of the four ADSRs of every voice."""
        stage, rem, level = s["stage"], s["rem"], s["level"]
        sus = torch.clamp(self.sustain * s["velocity"], 0.0, 1.0)
        # the release slope lands on 0 at the stage's end from where the
        # level is now
        cur = torch.clamp(level, 0.0, 1.0)
        inc = torch.where((cur <= 0.0) | (rem == 0), torch.zeros_like(cur),
                          -cur / torch.clamp_min(rem, 1).to(self.dt))
        timed = (stage == ATTACK) | (stage == DECAY) | (stage == RELEASE)
        active = timed & (rem > 0)
        done = timed & (torch.where(rem > 0, rem - 1, rem) == 0)
        stepped = torch.where(
            stage == ATTACK, torch.clamp(level + (1.0 - level) * self.a_c,
                                         0.0, 1.0),
            torch.where(stage == DECAY,
                        torch.clamp(level + (sus - level) * self.d_c,
                                    0.0, 1.0),
                        torch.clamp(level + inc, 0.0, 1.0)))
        level = torch.where(active, stepped, torch.where(
            stage == SUSTAIN, sus, torch.where(stage == IDLE,
                                               torch.zeros_like(level),
                                               level)))
        rem = torch.where(active, rem - 1, rem)
        a_done = done & (stage == ATTACK)
        d_done = done & (stage == DECAY)
        r_done = done & (stage == RELEASE)
        level = torch.where(a_done, torch.ones_like(level), level)
        level = torch.where(d_done, sus, level)
        level = torch.where(r_done, torch.zeros_like(level), level)
        s["stage"] = torch.where(a_done, DECAY, torch.where(
            d_done, SUSTAIN, torch.where(r_done, IDLE, stage)))
        s["rem"] = torch.where(a_done, self.d_n.expand_as(rem),
                               torch.where(d_done | r_done, 0, rem))
        s["level"] = level
        return level

    def run_block(self, s: dict, gates: dict, B: int):
        """One block from ``s`` (changed in place) with the voices' gate
        events ``{voice: [(offset, gate, frequency)]}``; the mono block
        ``[B]`` in float64."""
        at = {}
        for v, evs in gates.items():
            for off, g, fr in evs:
                at.setdefault(off, []).append((v, g, fr))
        out = torch.zeros(B, dtype=self.dt)
        h, g, k = self.h, self.g, self.k
        sin = lambda turns: torch.sin(2.0 * math.pi * turns)  # noqa: E731
        mix = self.route
        for n in range(B):
            for v, gate, fr in at.get(n, ()):
                if gate > 0.0:
                    s["freq"][v] = fr
                self._gate(s, v, gate)
            env = self._envelopes(s)
            amps = env[:, :3] * self.level
            ph, pv, fb = s["phases"], s["prevs"], self.feedback
            s3 = sin(ph[:, 0] + pv[:, 0] * fb[0])
            o3 = s3 * amps[:, 0]
            s2 = sin(ph[:, 1] + o3 * (1.0 - mix) + pv[:, 1] * fb[1])
            o2 = s2 * amps[:, 1]
            s1 = sin(ph[:, 2] + (o2 + o3 * mix) + pv[:, 2] * fb[2])
            o1 = s1 * amps[:, 2]
            s["prevs"] = torch.stack([o3, o2, o1], dim=1)
            s["phases"] = (ph + s["freq"][:, None] * self.ratio / self.sr) \
                % 1.0
            x, z0, z1 = o1, s["z0"], s["z1"]
            high = (x - z0 * k - z1) * h
            band = high * g + z0
            low = band * g + z1
            s["z0"], s["z1"] = high * g + band, band * g + low
            out[n] = (low * self.gain).sum()
        return out.to(torch.float64)


def make(config: dict, dtype=torch.float64) -> FmSynth:
    return FmSynth(int(config["voices"]), float(config["sample_rate"]),
                   config["patch"], dtype)
