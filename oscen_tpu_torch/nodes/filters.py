"""Filters.

Counterpart of ``oscen_tpu/nodes/filters.py``; holds :class:`TptFilter`,
the Zavalishin topology-preserving SVF lowpass (reference
filters/tpt/mod.rs).  ``IirLowpass``, ``LP18Filter`` and ``DualLP18Diff``
come with their slices (ROADMAP.md queue 1).

The block path keeps the reference's per-sample op order: one
``tpt_svf_scan`` over all instances and channels (the kernel on the card),
with coefficients that are either hoisted ``[C]`` rows or per-sample
``[C, B]`` planes.  ``TptFilter`` takes a leading instance axis
(``BATCHED``): state ``[C(, ch)]``, inputs ``[C, B(, ch)]``.  ``tan`` and
the divisions go through ``ops/fmath.py`` so the CPU and the card compute
the same float32 values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.types import SampleRate, stream, value
from ..graph import explain
from ..graph.node import Node
from ..ops import fmath
from ..ops.cuda.iir import tpt_svf_scan

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
