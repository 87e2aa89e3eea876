"""Oscillators.

Counterpart of ``oscen_tpu/nodes/oscillators.py``: the naive
:class:`Oscillator` and the anti-aliased :class:`PolyBlepOscillator` of the
reference (oscillators/mod.rs).  The block path accumulates the phase with
the exact per-sample wrap (``ops/scan.py::exact_wrapped_phase``, one
``phase_scan`` over all instances), then synthesizes the waveform on the
whole block at once with branchless masked arithmetic.

Both take a leading instance axis (``BATCHED``): state ``[C]``, inputs
``[C, B]``; their ``tick`` is the reference's per-sample math with the
block path's float32 helpers.  Divisions by constants and ``sin`` go through ``ops/fmath.py``
so the CPU and the card compute the same float32 values; a division by a
constant is the product with its float32 reciprocal, as XLA compiles it in
the JAX package (``fmath.div_const``), so the phase increments, and with
them the phases, equal the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.types import SampleRate, stream, value
from ..graph import explain
from ..graph.node import Node
from ..ops import fmath
from ..ops.scan import exact_wrapped_phase

TAU = 2.0 * math.pi
F32_EPS = float(np.finfo(np.float32).eps)


def _wrap_phase(p):
    """``rem_euclid(1.0)`` (reference oscillators/mod.rs:171-174)."""
    return p - torch.floor(p)


def _rust_rem(p):
    """Rust ``%`` (truncated remainder) by 1.0."""
    return p - torch.trunc(p)


# --------------------------------------------------------------------- #
# Naive Oscillator (fn-pointer waveform; reference oscillators/mod.rs:7-76)
# --------------------------------------------------------------------- #
def _naive_sine(p):
    return fmath.sin(p * TAU)


def _naive_square(p):
    return torch.where(p < 0.5, 1.0, -1.0)


def _naive_saw(p):
    """Reference 'anti-aliased' saw with a polynomial transition region
    (oscillators/mod.rs:45-61)."""
    tw = 0.1
    raw = 2.0 * p - 1.0
    edge = 1.0 - tw / 2.0
    t = fmath.div_const(p - edge, tw / 2.0)
    smoothed = -1.0 + (1.0 - t * t) * (raw + 1.0)
    return torch.where(p > edge, smoothed, raw)


_NAIVE_WAVEFORMS = {
    "sine": _naive_sine,
    "square": _naive_square,
    "saw": _naive_saw,
}


def _increment(frequency, sr_hz, folded_ins, clamp):
    """Phase increment per sample, ``frequency / sr`` as the JAX package
    computes it: a runtime frequency is divided by the product with the
    float32 reciprocal (XLA's form, ``fmath.div_const``); a literal one
    (an unconnected default, a ``Const``; ``folded_ins`` holds both the
    frequency and its modulation) XLA folds at compile time with a true
    float32 division, and so does this on the host.  The two differ by an
    ulp at rates such as 44.1 kHz, enough for a saw's phase to drift."""
    sr_hz = max(sr_hz, F32_EPS)
    if folded_ins and "frequency" in folded_ins \
            and "frequency_mod" in folded_ins:
        f = np.float32(folded_ins["frequency"]) * (
            np.float32(1.0) + np.float32(folded_ins["frequency_mod"]))
        if clamp:
            f = max(f, np.float32(0.0))
        return torch.full_like(frequency,
                               float(np.float32(f) / np.float32(sr_hz)))
    return fmath.div_const(frequency, sr_hz)


def _phase_state():
    return {"phase": torch.tensor(0.0, dtype=torch.float32)}


class Oscillator(Node):
    """Naive waveform oscillator (reference oscillators/mod.rs:7-76)."""

    INPUTS = (value("frequency", 440.0), stream("frequency_mod", 0.0),
              value("amplitude", 1.0))
    OUTPUTS = (stream("output"),)
    BATCHED = True

    def __init__(self, frequency: float = 440.0, amplitude: float = 1.0,
                 waveform: str = "sine"):
        self.frequency = float(frequency)
        self.amplitude = float(amplitude)
        if waveform not in _NAIVE_WAVEFORMS:
            raise ValueError(f"unknown waveform {waveform!r}")
        self.waveform = waveform
        self.INPUTS = (value("frequency", self.frequency),
                       stream("frequency_mod", 0.0),
                       value("amplitude", self.amplitude))

    @classmethod
    def sine(cls, frequency: float, amplitude: float) -> "Oscillator":
        return cls(frequency, amplitude, "sine")

    @classmethod
    def square(cls, frequency: float, amplitude: float) -> "Oscillator":
        return cls(frequency, amplitude, "square")

    @classmethod
    def saw(cls, frequency: float, amplitude: float) -> "Oscillator":
        return cls(frequency, amplitude, "saw")

    def init_state(self, sr: SampleRate):
        return _phase_state()

    def tick(self, state, ins, sr):
        frequency = ins["frequency"] * (1.0 + ins["frequency_mod"])
        out = _NAIVE_WAVEFORMS[self.waveform](_rust_rem(state["phase"])) \
            * ins["amplitude"]
        phase = state["phase"] + fmath.div_const(frequency, sr.hz)
        return {"phase": _rust_rem(phase)}, {"output": out}

    def process_block(self, state, ins, events, sr, block_len,
                      folded_ins=None):
        dt = _increment(ins["frequency"] * (1.0 + ins["frequency_mod"]),
                        sr.hz, folded_ins, clamp=False)  # [C, B]
        # The reference keeps the phase in (-1, 1) by a truncated
        # remainder; for non-negative frequencies floor- and trunc-wrap
        # coincide, so the exact scan equals the per-sample tick.
        before, carry = exact_wrapped_phase(state["phase"], dt.t())
        out = _NAIVE_WAVEFORMS[self.waveform](_rust_rem(before.t()))
        return {"phase": carry}, {"output": out * ins["amplitude"]}


# --------------------------------------------------------------------- #
# PolyBLEP oscillator (reference oscillators/mod.rs:86-233)
# --------------------------------------------------------------------- #
def poly_blep(t, dt):
    """Branchless polyBLEP residual (reference :139-153)."""
    safe = torch.clamp_min(dt, F32_EPS)
    x0 = t / safe
    lo = x0 + x0 - x0 * x0 - 1.0
    x1 = (t - 1.0) / safe
    hi = x1 * x1 + x1 + x1 + 1.0
    r = torch.where(t < dt, lo, torch.where(t > 1.0 - dt, hi, 0.0))
    return torch.where(dt <= F32_EPS, 0.0, r)


def poly_blamp(t, dt):
    """Branchless polyBLAMP residual (reference :155-169)."""
    safe = torch.clamp_min(dt, F32_EPS)
    x0 = t / safe - 1.0
    lo = fmath.div_const(-(x0 * x0 * x0), 3.0)
    x1 = (t - 1.0) / safe + 1.0
    hi = fmath.div_const(x1 * x1 * x1, 3.0)
    r = torch.where(t < dt, lo, torch.where(t > 1.0 - dt, hi, 0.0))
    return torch.where(dt <= F32_EPS, 0.0, r)


class PolyBlepOscillator(Node):
    """Anti-aliased oscillator with polyBLEP/polyBLAMP residuals."""

    WAVEFORMS = ("sine", "saw", "square", "triangle")

    OUTPUTS = (stream("output"),)
    BATCHED = True

    def __init__(self, frequency: float = 440.0, amplitude: float = 1.0,
                 waveform: str = "sine"):
        if waveform not in self.WAVEFORMS:
            raise ValueError(f"unknown waveform {waveform!r}")
        self.waveform = waveform
        self.INPUTS = (stream("phase_mod", 0.0),
                       value("frequency", float(frequency)),
                       stream("frequency_mod", 0.0),
                       value("amplitude", float(amplitude)),
                       value("pulse_width", 0.5))

    @classmethod
    def sine(cls, frequency: float, amplitude: float):
        return cls(frequency, amplitude, "sine")

    @classmethod
    def saw(cls, frequency: float, amplitude: float):
        return cls(frequency, amplitude, "saw")

    @classmethod
    def square(cls, frequency: float, amplitude: float):
        return cls(frequency, amplitude, "square")

    @classmethod
    def triangle(cls, frequency: float, amplitude: float):
        return cls(frequency, amplitude, "triangle")

    def init_state(self, sr: SampleRate):
        return _phase_state()

    def _synthesize(self, phase, dt, pulse_width, frequency, sr_hz):
        """Waveform value at ``phase`` (already wrapped) — the body of the
        reference's match (oscillators/mod.rs:194-224)."""
        wf = self.waveform
        if wf == "sine":
            val = fmath.sin(phase * TAU)
        elif wf == "saw":
            val = 2.0 * phase - 1.0 - poly_blep(phase, dt)
        elif wf == "square":
            y = torch.where(phase < pulse_width, 1.0, -1.0)
            y = y + poly_blep(phase, dt)
            t2 = _wrap_phase(phase + 1.0 - pulse_width)
            val = y - poly_blep(t2, dt)
        else:  # triangle
            y = 4.0 * phase
            y = torch.where(y >= 3.0, y - 4.0,
                            torch.where(y > 1.0, 2.0 - y, y))
            t1 = _wrap_phase(phase + 0.25)
            t2 = _wrap_phase(phase + 0.75)
            val = y + 4.0 * dt * (poly_blamp(t1, dt) - poly_blamp(t2, dt))
        if wf != "sine":
            # Falls back to sine above sr/4 (reference :194).
            val = torch.where(frequency >= sr_hz * 0.25,
                              fmath.sin(phase * TAU), val)
        return val

    def tick(self, state, ins, sr):
        frequency = torch.clamp_min(
            ins["frequency"] * (1.0 + ins["frequency_mod"]), 0.0)
        pulse_width = torch.clamp(ins["pulse_width"], 0.0001, 0.9999)
        phase = _wrap_phase(state["phase"] + ins["phase_mod"])
        fps = fmath.div_const(frequency, max(sr.hz, F32_EPS))
        val = self._synthesize(phase, torch.clamp_max(fps, 1.0),
                               pulse_width, frequency, sr.hz)
        return ({"phase": _wrap_phase(state["phase"] + fps)},
                {"output": val * ins["amplitude"]})

    def process_block(self, state, ins, events, sr, block_len,
                      folded_ins=None):
        frequency = torch.clamp_min(
            ins["frequency"] * (1.0 + ins["frequency_mod"]), 0.0)  # [C, B]
        fps = _increment(frequency, sr.hz, folded_ins, clamp=True)
        before, carry = exact_wrapped_phase(state["phase"], fps.t())
        pulse_width = torch.clamp(ins["pulse_width"], 0.0001, 0.9999)
        phase = _wrap_phase(before.t() + ins["phase_mod"])
        dt = torch.clamp_max(fps, 1.0)
        val = self._synthesize(phase, dt, pulse_width, frequency, sr.hz)
        return {"phase": carry}, {"output": val * ins["amplitude"]}

    def process_block_batched(self, state, ins, events, sr, block_len,
                              folded_ins=None):
        """All voices at once with the exact per-sample phase wrap: ONE
        ``phase_scan`` over the instances (the kernel on the card), then the
        polyBLEP synthesis time-parallel on the exact phases.  The same
        function as :meth:`process_block`, which is already batched."""
        explain.note(kernel="phase_scan")
        return self.process_block(state, ins, events, sr, block_len,
                                  folded_ins)
