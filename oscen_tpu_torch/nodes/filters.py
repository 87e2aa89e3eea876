"""Filters.

Counterpart of ``oscen_tpu/nodes/filters.py``:

- :class:`TptFilter` — Zavalishin topology-preserving SVF lowpass
  (reference filters/tpt/mod.rs);
- :class:`IirLowpass` — JUCE-style biquad, Direct Form II Transposed
  (reference filters/iir_lowpass/mod.rs);
- :class:`LP18Filter` — three-pole 18 dB/oct lowpass with a tanh-saturated
  first pole (reference examples/nih-twin-peaks/src/lp18_filter.rs);
- :class:`DualLP18Diff` — two LP18s over one input in adjacent lanes of
  one scan, output their difference (the twin-peaks core).

Every block path keeps the reference's per-sample op order through one
scan over all instances (the kernel on the card): ``tpt_svf_scan``,
``biquad_scan`` or ``lp18_scan`` of ``ops/cuda/iir.py``, with coefficients
that are either hoisted ``[C]`` rows or per-sample ``[C, B]`` planes.  The
nodes take a leading instance axis (``BATCHED``): state ``[C(, ...)]``,
inputs ``[C, B(, ch)]``; instances (and the dual node's two filters) are
the scan's lanes.  ``tan``, ``tanh`` and the divisions go through
``ops/fmath.py`` so the CPU and the card compute the same float32 values.
Each node's ``tick`` is one sample of its scan's plain version, with the
reference's coefficient cadence.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.types import SampleRate, stream, value
from ..graph import explain
from ..graph.node import Node
from ..ops import fmath
from ..ops.cuda.iir import _snap, biquad_scan, lp18_scan, tpt_svf_scan

PI = math.pi
F32_EPS = float(np.finfo(np.float32).eps)

_PARAMS = ("cutoff", "q", "f_mod")
_COEF_STATE = ("current_cutoff", "current_q", "h", "g", "r", "k")


def _tpt_coefficients(sr_hz: float, cutoff, q):
    """Zavalishin coefficient set (reference tpt/mod.rs:69-82)."""
    nyquist = sr_hz * 0.5 - F32_EPS
    freq = torch.clamp(cutoff, 20.0, nyquist)
    period = 0.5 / sr_hz
    f = (2.0 * sr_hz) * fmath.tan(2.0 * PI * freq * period) * period
    inv_q = fmath.rdiv(1.0, q)
    h = fmath.rdiv(1.0, 1.0 + inv_q * f + f * f)
    return h, f, inv_q, f + inv_q  # h, g, r, k


class TptFilter(Node):
    """Topology-preserving SVF lowpass, generic over channel count."""

    BATCHED = True

    def __init__(self, cutoff: float = 1000.0, q: float = 0.707,
                 channels: int = 1):
        self.cutoff = float(cutoff)
        self.q = float(q)
        self.channels = int(channels)
        self.INPUTS = (stream("input", 0.0, channels=channels),
                       stream("cutoff", self.cutoff),
                       value("q", self.q),
                       stream("f_mod", 0.0))
        self.OUTPUTS = (stream("output", channels=channels),)

    def init_state(self, sr: SampleRate):
        f32 = torch.float32
        h, g, r, k = _tpt_coefficients(
            sr.hz, torch.tensor(self.cutoff, dtype=f32),
            torch.tensor(self.q, dtype=f32))
        zeros = torch.zeros(() if self.channels == 1 else (self.channels,),
                            dtype=f32)
        return {
            "z0": zeros, "z1": zeros.clone(),
            "current_cutoff": torch.tensor(self.cutoff, dtype=f32),
            "current_q": torch.tensor(self.q, dtype=f32),
            "h": h, "g": g, "r": r, "k": k,
        }

    @staticmethod
    def _apply_parameter_updates(state, ins, sr_hz):
        """Per-sample parameter sanitize + recompute-on-change
        (reference tpt/mod.rs:85-102)."""
        nyquist = sr_hz * 0.5 - F32_EPS
        max_cutoff = min(nyquist, 20_000.0)
        cutoff_base = torch.clamp(ins["cutoff"], 20.0, max_cutoff)
        q = torch.clamp(ins["q"], 0.1, 10.0)
        modulation = torch.clamp(ins["f_mod"], -1.0, 1.0)
        min_factor = fmath.rdiv(20.0, cutoff_base)
        max_factor = fmath.rdiv(max_cutoff, cutoff_base)
        factor = torch.clamp(1.0 + modulation, min_factor, max_factor)
        cutoff = torch.clamp(cutoff_base * factor, 20.0, max_cutoff)

        changed = torch.logical_or(
            torch.abs(cutoff - state["current_cutoff"]) > F32_EPS,
            torch.abs(q - state["current_q"]) > F32_EPS)
        h, g, r, k = _tpt_coefficients(sr_hz, cutoff, q)

        def pick(new, old):
            return torch.where(changed, new, old)
        return {
            **state,
            "current_cutoff": pick(cutoff, state["current_cutoff"]),
            "current_q": pick(q, state["current_q"]),
            "h": pick(h, state["h"]), "g": pick(g, state["g"]),
            "r": pick(r, state["r"]), "k": pick(k, state["k"]),
        }

    def tick(self, state, ins, sr):
        state = self._apply_parameter_updates(state, ins, sr.hz)
        x, z0, z1 = ins["input"], state["z0"], state["z1"]
        h, g, k = state["h"], state["g"], state["k"]
        if self.channels > 1:   # one coefficient set per instance
            h, g, k = h[..., None], g[..., None], k[..., None]
        high = (x - z0 * k - z1) * h
        band = high * g + z0
        low = band * g + z1
        return ({**state, "z0": high * g + band, "z1": band * g + low},
                {"output": low})

    def _filter(self, state, ins, sr, block_len, hoisted: bool):
        """One block for all instances.  ``hoisted``: every parameter is
        block-constant, so one ``[C]`` coefficient set serves the block
        (no ``[C, B]`` tan sweep); otherwise the coefficients are recomputed
        per sample.  For constant parameters both give the same values:
        the recompute is a pure function of each sample's parameters."""
        if hoisted:
            st = self._apply_parameter_updates(
                state, {p: ins[p][:, 0] for p in _PARAMS}, sr.hz)
            fin = {key: st[key] for key in _COEF_STATE}
        else:
            # the block-start values against every sample's parameters
            st = self._apply_parameter_updates(
                {**state, **{key: state[key][:, None]
                             for key in _COEF_STATE}}, ins, sr.hz)
            fin = {key: st[key][:, -1] for key in _COEF_STATE}
        y, z0, z1 = self._scan(ins["input"], st["h"], st["g"], st["k"],
                               state["z0"], state["z1"])
        return {**state, **fin, "z0": z0, "z1": z1}, {"output": y}

    def _scan(self, x, h, g, k, z0, z1):
        """``tpt_svf_scan`` over the instances (and channels) as lanes:
        ``x`` ``[C, B(, ch)]``, coefficients ``[C]`` or ``[C, B]``,
        ``z`` ``[C(, ch)]``; returns ``y`` ``[C, B(, ch)]`` and the
        states."""
        C, B = x.shape[:2]
        ch = self.channels
        lanes = C * ch

        def coef(c):
            if c.dim() == 1:                                 # [C] row
                return c[:, None].expand(C, ch).reshape(lanes).contiguous()
            return c.t()[:, :, None].expand(B, C, ch).reshape(B, lanes) \
                .contiguous()                                # [B, lanes]
        xt = x.reshape(C, B, ch).transpose(0, 1).reshape(B, lanes) \
            .contiguous()
        y, z0n, z1n = tpt_svf_scan(xt, coef(h), coef(g), coef(k),
                                   z0.reshape(lanes).contiguous(),
                                   z1.reshape(lanes).contiguous())
        y = y.reshape(B, C, ch).transpose(0, 1)
        if ch == 1:
            y = y[:, :, 0]
        return y, z0n.reshape(z0.shape), z1n.reshape(z1.shape)

    def process_block(self, state, ins, events, sr, block_len):
        """Per-sample coefficients (the reference's recompute-on-change,
        vectorized), then the exact-order scan."""
        return self._filter(state, ins, sr, block_len, hoisted=False)

    def process_block_batched(self, state, ins, events, sr, block_len,
                              const_ins=frozenset()):
        """Voice-batched block path: ONE ``tpt_svf_scan`` over all
        instances.  The coefficient form is chosen from ``const_ins`` alone
        (which parameters are block-constant this block, known on the
        host), never by reading device values: hoisted ``[C]`` rows when
        every parameter is constant, per-sample planes otherwise."""
        hoisted = all(p in const_ins for p in _PARAMS)
        explain.note(kernel="tpt_svf_scan",
                     coef_path="hoisted" if hoisted else "sweep")
        return self._filter(state, ins, sr, block_len, hoisted)


class IirLowpass(Node):
    """JUCE-style biquad lowpass, Direct Form II Transposed.

    The coefficients follow the reference's update cadence: recomputed from
    the ``cutoff`` and ``q`` inputs every 32 frames (``frame_counter``
    carried across blocks), held in between.  A block latches each
    sample's candidate coefficients at its update frames into per-sample
    ``[C, B]`` planes, then runs one ``biquad_scan`` over all instances.
    """

    BATCHED = True
    INPUTS = (stream("input", 0.0), value("cutoff", 1000.0),
              value("q", 1.0 / math.sqrt(2.0)))
    OUTPUTS = (stream("output"),)
    FRAMES_PER_UPDATE = 32
    COEFS = ("b0", "b1", "b2", "a1", "a2")

    def __init__(self, cutoff: float = 1000.0,
                 q: float = 1.0 / math.sqrt(2.0)):
        self.cutoff = float(cutoff)
        self.q = float(q)
        self.INPUTS = (stream("input", 0.0), value("cutoff", self.cutoff),
                       value("q", self.q))

    @staticmethod
    def _coefficients(sr_hz, cutoff, q, div):
        """JUCE makeLowPass (reference iir_lowpass/mod.rs:84-100).  ``div``
        is the division by the sample rate: the JAX package computes it as
        a true quotient eagerly (``init_state``) and as XLA's reciprocal
        product inside a compiled graph (the blocks)."""
        nyquist = sr_hz * 0.5 - F32_EPS
        freq = torch.clamp(cutoff, 20.0, nyquist)
        q = torch.clamp(q, min=0.01)
        n = fmath.rdiv(1.0, fmath.tan(div(PI * freq, sr_hz)))
        n2 = n * n
        inv_q = fmath.rdiv(1.0, q)
        c1 = fmath.rdiv(1.0, 1.0 + inv_q * n + n2)
        return (c1, c1 * 2.0, c1, c1 * 2.0 * (1.0 - n2),
                c1 * (1.0 - inv_q * n + n2))

    def init_state(self, sr: SampleRate):
        f32 = torch.float32
        coefs = self._coefficients(
            sr.hz, torch.tensor(self.cutoff, dtype=f32),
            torch.tensor(self.q, dtype=f32), fmath.div)
        return {**dict(zip(self.COEFS, coefs)),
                "v1": torch.zeros((), dtype=f32),
                "v2": torch.zeros((), dtype=f32),
                "frame_counter": torch.zeros((), dtype=torch.int32)}

    def tick(self, state, ins, sr):
        """One sample: the coefficients latched on the 32-frame cadence,
        then the DF-II-T step with the reference's 1e-15 snaps."""
        update = state["frame_counter"] == 0
        cand = self._coefficients(sr.hz, ins["cutoff"], ins["q"],
                                  fmath.div_const)
        c0, c1, c2, d1, d2 = [torch.where(update, c, state[k])
                              for c, k in zip(cand, self.COEFS)]
        x = _snap(ins["input"])
        out = c0 * x + state["v1"]
        v1 = _snap(c1 * x - d1 * out + state["v2"])
        v2 = _snap(c2 * x - d2 * out)
        return ({**dict(zip(self.COEFS, (c0, c1, c2, d1, d2))),
                 "v1": v1, "v2": v2,
                 "frame_counter": (state["frame_counter"] + 1)
                 % self.FRAMES_PER_UPDATE},
                {"output": out})

    def process_block(self, state, ins, events, sr, block_len):
        B = block_len
        x = ins["input"]
        t = torch.arange(B, dtype=torch.int32, device=x.device)
        counter = state["frame_counter"]
        update = (counter[:, None] + t) % self.FRAMES_PER_UPDATE == 0
        cand = self._coefficients(sr.hz, ins["cutoff"], ins["q"],
                                  fmath.div_const)
        # the last update frame at or before each sample (-1: none yet, the
        # carried coefficients hold): a running max over the frame indices
        last = torch.cummax(torch.where(update, t.long(), -1), dim=1).values
        have = last >= 0
        at = last.clamp(min=0)
        coefs = [torch.where(have, torch.gather(c, 1, at), state[k][:, None])
                 for c, k in zip(cand, self.COEFS)]
        explain.note(kernel="biquad_scan", lanes=x.shape[0],
                     sequential_exact=True)
        y, v1, v2 = biquad_scan(x.t().contiguous(),
                                *[c.t().contiguous() for c in coefs],
                                state["v1"], state["v2"])
        return ({**{k: c[:, -1] for k, c in zip(self.COEFS, coefs)},
                 "v1": v1, "v2": v2,
                 "frame_counter": (counter + B) % self.FRAMES_PER_UPDATE},
                {"output": y.t()})


def _lp18_g0(cutoff: float, sr_hz: float) -> np.float32:
    """The LP18's initial ``g``, as the JAX package's eager ``init_state``
    computes it: numpy's float32 ``tan`` of the clipped cutoff, one value
    at a time, so a single filter and the dual one agree bit for bit."""
    fc = np.clip(cutoff / sr_hz, 0.001, 0.33)
    return np.tan(PI * fc, dtype=np.float32)


class _LP18Scan(Node):
    """The LP18 block path shared by :class:`LP18Filter` (one filter per
    instance, lane shape ``[C]``) and :class:`DualLP18Diff` (two per
    instance, ``[C, 2]``).

    Coefficients replay the reference's recompute-on-change cadence: each
    sample's ``g`` and ``h`` are recomputed where its cutoff, fmod or
    resonance differs from the values carried from the last block (per
    sample against the carried values, not a sequential latch, as in the
    JAX package), and the carried ``last_*`` are taken from the block's
    last sample.  When every parameter is block-constant (``const_ins``)
    one ``[C(, 2)]`` row serves the block; the values are the same."""

    BATCHED = True
    PARAMS = ("cutoff", "fmod", "resonance")
    LAST = ("last_cutoff", "last_fmod", "last_resonance")

    @staticmethod
    def _coefficients(state, cutoff, fmod, resonance, sr_hz):
        """(g, h, last values) from one set of parameters (rows, or
        per-sample planes against the carried values)."""
        cut_changed = torch.logical_or(cutoff != state["last_cutoff"],
                                       fmod != state["last_fmod"])
        fc = torch.clamp(fmath.div_const(cutoff + fmod, sr_hz), 0.001, 0.33)
        g = torch.where(cut_changed, fmath.tan(PI * fc), state["g"])
        res_changed = resonance != state["last_resonance"]
        h = torch.where(res_changed,
                        2.0 * torch.clamp(resonance, 0.0, 0.99), state["h"])
        last = (torch.where(cut_changed, cutoff, state["last_cutoff"]),
                torch.where(cut_changed, fmod, state["last_fmod"]),
                torch.where(res_changed, resonance, state["last_resonance"]))
        return g, h, dict(zip(_LP18Scan.LAST, last))

    @staticmethod
    def _poles(x, g, h, z0, z1, z2):
        """One sample of the three poles, in ``plain_lp18_scan``'s op order
        (the same float32 ``tanh`` and true quotient as K8)."""
        hp = (x - h * z0 - z1 - z2) / (1.0 + g)
        bp1 = g * hp + z0
        bp2 = g * bp1 + z1
        return fmath.tanh(bp1), bp2, g * bp2 + z2

    def _scan(self, state, x, params, sr, hoisted: bool, **note):
        """One block for every lane: ``x`` ``[B, L]`` (L lanes, instance
        major), ``params`` ``[C, B(, 2)]``; returns the new state and
        ``y`` ``[B, L]``."""
        B = x.shape[0]
        if hoisted:
            g, h, last = self._coefficients(
                state, *[params[p][:, 0] for p in self.PARAMS], sr.hz)
            fin = {"g": g, "h": h, **last}
            g, h = g.reshape(-1), h.reshape(-1)
        else:
            carried = {k: state[k][:, None]
                       for k in ("g", "h") + self.LAST}
            g, h, last = self._coefficients(
                carried, *[params[p] for p in self.PARAMS], sr.hz)
            fin = {k: v[:, -1] for k, v in
                   {"g": g, "h": h, **last}.items()}
            g = g.movedim(1, 0).reshape(B, -1).contiguous()
            h = h.movedim(1, 0).reshape(B, -1).contiguous()
        explain.note(kernel="lp18_scan", lanes=x.shape[1], **note,
                     coef_path="hoisted" if hoisted else "sweep",
                     sequential_exact=True)
        z = state["z"]                                   # [C, 3(, 2)]
        y, zn = lp18_scan(x, g, h,
                          z.movedim(1, 0).reshape(3, -1).contiguous())
        zn = zn.reshape((3,) + tuple(z.shape[:1]) + tuple(z.shape[2:]))
        return {**state, **fin, "z": zn.movedim(0, 1)}, y


class LP18Filter(_LP18Scan):
    """Three-pole 18 dB/oct lowpass with a tanh-saturated first pole
    (reference examples/nih-twin-peaks/src/lp18_filter.rs).

    The tanh makes this a nonlinear recurrence (no associative-scan form),
    so the block runs the sequential ``lp18_scan``: one lane per instance.
    """

    INPUTS = (stream("input", 0.0), value("cutoff", 1000.0),
              value("fmod", 0.0), value("resonance", 0.0))
    OUTPUTS = (stream("output"),)

    def __init__(self, cutoff: float = 1000.0, resonance: float = 0.0):
        self.cutoff = float(cutoff)
        self.resonance = float(np.clip(resonance, 0.0, 0.99))
        self.INPUTS = (stream("input", 0.0), value("cutoff", self.cutoff),
                       value("fmod", 0.0), value("resonance", self.resonance))

    def init_state(self, sr: SampleRate):
        f32 = torch.float32
        return {"z": torch.zeros((3,), dtype=f32),
                "g": torch.tensor(_lp18_g0(self.cutoff, sr.hz)),
                "h": torch.tensor(2.0 * self.resonance, dtype=f32),
                "last_cutoff": torch.tensor(self.cutoff, dtype=f32),
                "last_fmod": torch.zeros((), dtype=f32),
                "last_resonance": torch.tensor(self.resonance, dtype=f32)}

    def tick(self, state, ins, sr):
        g, h, last = self._coefficients(state, ins["cutoff"], ins["fmod"],
                                        ins["resonance"], sr.hz)
        z = state["z"]
        z = self._poles(ins["input"], g, h, z[..., 0], z[..., 1], z[..., 2])
        return ({**state, **last, "g": g, "h": h,
                 "z": torch.stack(z, dim=-1)}, {"output": z[2]})

    def process_block(self, state, ins, events, sr, block_len,
                      const_ins=frozenset()):
        hoisted = all(p in const_ins for p in self.PARAMS)
        st, y = self._scan(state, ins["input"].t().contiguous(), ins, sr,
                           hoisted)
        return st, {"output": y.t()}


class DualLP18Diff(_LP18Scan):
    """The fused twin-peaks core: two independent LP18s over the same input
    in adjacent lanes of ONE ``lp18_scan``; the output is their difference
    (the movable resonant band, reference
    examples/nih-twin-peaks/src/lib.rs:15-48).

    Every op of the scan and of the coefficient updates is elementwise over
    lanes, and ``tanh`` rounds once from float64, so the output equals the
    two-``LP18Filter`` build bit for bit on the CPU and on the card.
    """

    INPUTS = (stream("input", 0.0), value("cutoff_a", 1000.0),
              value("cutoff_b", 1900.0), value("fmod", 0.0),
              value("resonance", 0.54))
    OUTPUTS = (stream("output"),)

    def __init__(self, cutoff_a: float = 1000.0, cutoff_b: float = 1900.0,
                 resonance: float = 0.54):
        self.cutoffs = (float(cutoff_a), float(cutoff_b))
        self.resonance = float(np.clip(resonance, 0.0, 0.99))
        self.INPUTS = (stream("input", 0.0),
                       value("cutoff_a", self.cutoffs[0]),
                       value("cutoff_b", self.cutoffs[1]),
                       value("fmod", 0.0),
                       value("resonance", self.resonance))

    def init_state(self, sr: SampleRate):
        f32 = torch.float32
        return {"z": torch.zeros((3, 2), dtype=f32),
                "g": torch.tensor([_lp18_g0(c, sr.hz)
                                   for c in self.cutoffs], dtype=f32),
                "h": torch.full((2,), 2.0 * self.resonance, dtype=f32),
                "last_cutoff": torch.tensor(self.cutoffs, dtype=f32),
                "last_fmod": torch.zeros((2,), dtype=f32),
                "last_resonance": torch.full((2,), self.resonance,
                                             dtype=f32)}

    def tick(self, state, ins, sr):
        pair = ins["cutoff_a"].shape + (2,)
        g, h, last = self._coefficients(
            state, torch.stack([ins["cutoff_a"], ins["cutoff_b"]], dim=-1),
            ins["fmod"][..., None].expand(pair),
            ins["resonance"][..., None].expand(pair), sr.hz)
        z = state["z"]                                   # [(C,) 3, 2]
        z = self._poles(ins["input"][..., None], g, h, z[..., 0, :],
                        z[..., 1, :], z[..., 2, :])
        return ({**state, **last, "g": g, "h": h,
                 "z": torch.stack(z, dim=-2)},
                {"output": z[2][..., 0] - z[2][..., 1]})

    def process_block(self, state, ins, events, sr, block_len,
                      const_ins=frozenset()):
        B = block_len
        x = ins["input"]                                     # [C, B]
        C = x.shape[0]
        pair = (C, B, 2)
        params = {"cutoff": torch.stack([ins["cutoff_a"], ins["cutoff_b"]],
                                        dim=-1),
                  "fmod": ins["fmod"][..., None].expand(pair),
                  "resonance": ins["resonance"][..., None].expand(pair)}
        hoisted = all(p in const_ins for p in
                      ("cutoff_a", "cutoff_b", "fmod", "resonance"))
        lanes = x.t()[:, :, None].expand(B, C, 2).reshape(B, 2 * C) \
            .contiguous()
        st, y = self._scan(state, lanes, params, sr, hoisted,
                           fused_dual_filter=True)
        y = y.reshape(B, C, 2)
        return st, {"output": (y[..., 0] - y[..., 1]).t()}
