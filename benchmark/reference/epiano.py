"""Plain reference of the electric piano: oscen's ``examples/
electric-piano`` (``electric_piano_voice.rs``, ``tremolo.rs``) sample by
sample, in float64 (or in the precision asked for), with no kernel, no
cache, no closed form across samples.

A voice is 32 sine harmonics by complex rotation (a harmonic at or above
Nyquist holds still), weighted by per-harmonic envelopes: every 64 samples
each harmonic's target moves by its decay multiplier (or, released, its
release multiplier) and the amplitude is interpolated linearly toward it
over the next 64 samples, then held one sample.  A note-on sets the
voice's initial spectrum from the velocity and restarts the rotation at
zero phase; a note-off starts the release.  The voices are summed, times 3
each, and panned to stereo by a sine LFO.
"""

from __future__ import annotations

import math

import torch

H = 32
STEPS = 64

# electric_piano_voice.rs:10-47, the spectra sampled from an electric piano
VELOCITY_0 = [0.02, 0.05] + [0.0] * 30
VELOCITY_127 = [
    0.150869, 0.385766, 0.215543, 0.117811, 0.100411, 0.0128637,
    0.0288844, 0.00243388, 0.00963092, 0.0035634, 0.00256945, 0.00184799,
    0.000399878, 0.000660576, 3.00995e-05, 0.00021866, 9.33705e-05,
    0.000177973, 0.0002545, 0.000323602, 0.000779045, 0.000116569,
    0.000772873, 0.000364486, 0.000248027, 0.00018236, 3.27292e-05,
    6.64988e-05, 0.0, 0.0, 0.0, 0.0]
NOTE_PITCH = 60.0   # the voice keeps its constructor's pitch for the decay


class Piano:
    """``patch``: the configuration's parameters; ``dtype``: the precision
    every value is computed in."""

    def __init__(self, voices: int, sample_rate: float, patch: dict,
                 dtype=torch.float64):
        self.V, self.sr, self.p, self.dt = voices, sample_rate, patch, dtype
        f = lambda x: torch.tensor(x, dtype=dtype)   # noqa: E731
        h = torch.arange(H, dtype=torch.float64)
        p = patch
        base = (100.0 - p["decay_rate"]) / 40000.0
        ks = (48.0 - NOTE_PITCH) / 12.0 * (p["key_scaling"] * 0.02)
        adjusted = 1.0 - (base / (1.0 + ks) if ks > 0 else base * (1.0 - ks))
        hs = 1.0 - (100.0 - p["harmonic_decay"]) / 200000.0
        self.decay = f((adjusted * hs ** h).tolist())
        self.release = f([0.999 - (100.0 - p["release_rate"]) / 1000.0] * H)
        self.spec0, self.spec127 = f(VELOCITY_0), f(VELOCITY_127)
        self.h = h.to(dtype)
        self.trem_dt = p["vibrato_speed"] / sample_rate

    # ------------------------------------------------------------------
    def init_state(self, freqs) -> dict:
        z = torch.zeros((self.V, H), dtype=self.dt)
        return {"osc_re": z + 1.0, "osc_im": z.clone(), "cur": z.clone(),
                "tgt": z.clone(),
                "step": torch.full((self.V,), STEPS, dtype=torch.int64),
                "released": torch.zeros(self.V, dtype=torch.bool),
                "last": torch.zeros(self.V, dtype=self.dt),
                "freq": torch.tensor(freqs, dtype=self.dt),
                "trem": torch.zeros((), dtype=self.dt)}

    def from_program(self, state: dict, freqs) -> dict:
        """The reference's state from the program's at a block boundary:
        the rotations, the envelopes and the LFO's phase; each voice's
        frequency and rotation multipliers are the reference's own."""
        b, a = state["voices"]["bank"], state["voices"]["amp"]
        t = state["tremolo"]
        dt = lambda x: torch.as_tensor(x).to(torch.float64)  # noqa: E731
        phase = (dt(t["anchor"]) + dt(t["dt_last"]) * dt(t["k"])) % 1.0
        fr = torch.tensor(freqs, dtype=self.dt)
        return {"osc_re": dt(b["osc_re"]).to(self.dt),
                "osc_im": dt(b["osc_im"]).to(self.dt),
                "cur": dt(a["current"]).to(self.dt),
                "tgt": dt(a["target"]).to(self.dt),
                "step": torch.as_tensor(a["step"]).to(torch.int64),
                "released": torch.as_tensor(a["released"]).to(torch.bool),
                "last": fr.clone(), "freq": fr,
                "trem": phase.to(self.dt)}

    def program_view(self, state: dict) -> dict:
        """The program's state in the reference's names, for the gaps."""
        b, a, t = state["voices"]["bank"], state["voices"]["amp"], \
            state["tremolo"]
        d = lambda x: torch.as_tensor(x).to(torch.float64)  # noqa: E731
        return {"osc_re": d(b["osc_re"]), "osc_im": d(b["osc_im"]),
                "cur": d(a["current"]), "tgt": d(a["target"]),
                "step": torch.as_tensor(a["step"]).to(torch.int64),
                "released": torch.as_tensor(a["released"]).to(torch.bool),
                "trem": (d(t["anchor"]) + d(t["dt_last"]) * d(t["k"]))
                % 1.0}

    PHASES = ("trem",)
    # the target is left out: at a cycle's first sample it is recomputed,
    # and the program's closed form already holds the next cycle's there
    COMPARED = ("osc_re", "osc_im", "cur", "step", "released", "trem")

    # ------------------------------------------------------------------
    def _multipliers(self, freq):
        hf = freq[:, None] * (self.h + 1.0)
        ang = 2.0 * math.pi * hf / self.sr
        below = hf < self.sr * 0.5
        return (torch.where(below, torch.cos(ang), torch.ones_like(ang)),
                torch.where(below, torch.sin(ang), torch.zeros_like(ang)))

    def _trigger(self, s, v: int, vel: float) -> None:
        p = self.p
        vel_t = torch.tensor(vel, dtype=self.dt)
        amps = self.spec127 * vel_t + self.spec0 * (1.0 - vel_t)
        b = -0.2 + 0.8 * (p["brightness"] * 0.01) \
            + vel * p["velocity_scaling"] * 0.01 * 0.5
        s["cur"][v] = amps * (1.0 + b * self.h)
        s["step"][v] = 0
        s["released"][v] = False
        s["osc_re"][v] = 1.0
        s["osc_im"][v] = 0.0

    def run_block(self, s: dict, gates: dict, B: int):
        """One block from state ``s`` (changed in place) with the voices'
        gate events ``{voice: [(offset, gate, frequency)]}``; returns the
        stereo block ``[B, 2]`` in float64."""
        at = {}
        for v, evs in gates.items():
            for off, g, fr in evs:
                at.setdefault(off, []).append((v, g, fr))
        mul_re, mul_im = self._multipliers(s["freq"])
        out = torch.zeros(B, dtype=self.dt)
        depth = self.p["vibrato_intensity"]
        phases = (s["trem"] + torch.arange(B, dtype=self.dt) * self.trem_dt) \
            % 1.0
        for n in range(B):
            if n in at or n == 0:
                for v, g, fr in at.get(n, ()):
                    if g > 0.0:
                        s["freq"][v] = fr
                        self._trigger(s, v, g)
                    else:
                        s["released"][v] = True
                        s["step"][v] = 0
                changed = (s["freq"] > 0) & ((s["last"] - s["freq"]).abs()
                                             >= 0.01)
                if bool(changed.any()):
                    nr, ni = self._multipliers(s["freq"])
                    c = changed[:, None]
                    mul_re = torch.where(c, nr, mul_re)
                    mul_im = torch.where(c, ni, mul_im)
                    s["osc_re"] = torch.where(c, 1.0, s["osc_re"]).to(self.dt)
                    s["osc_im"] = torch.where(c, 0.0, s["osc_im"]).to(self.dt)
                    s["last"] = torch.where(changed, s["freq"], s["last"])
            # the envelopes: a new target at the cycle's start, then the
            # interpolation toward it, then one held sample
            step = s["step"][:, None]
            mult = torch.where(s["released"][:, None], self.release,
                               self.decay)
            s["tgt"] = torch.where(step == 0, s["cur"] * mult, s["tgt"])
            interp = step < STEPS
            tau = ((step + 1).to(self.dt)) / STEPS
            s["cur"] = torch.where(interp, s["cur"] * (1.0 - tau)
                                   + s["tgt"] * tau, s["tgt"])
            s["step"] = torch.where(interp[:, 0], s["step"] + 1, 0)
            re, im = s["osc_re"], s["osc_im"]
            s["osc_re"] = re * mul_re - im * mul_im
            s["osc_im"] = re * mul_im + im * mul_re
            out[n] = (s["osc_im"] * s["cur"]).sum() * 3.0
        pan = 0.5 + torch.sin(2.0 * math.pi * phases) * (depth / 3.0)
        s["trem"] = (s["trem"] + B * self.trem_dt) % 1.0
        y = torch.stack([out * pan, out * (1.0 - pan)], dim=-1)
        return y.to(torch.float64)


def make(config: dict, dtype=torch.float64) -> Piano:
    return Piano(int(config["voices"]), float(config["sample_rate"]),
                 config["patch"], dtype)

