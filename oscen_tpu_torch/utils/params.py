"""nih_params analogue: host-side parameter objects generated from specs.

Copy of ``oscen_tpu/utils/params.py`` (pure host code).  The reference's
``nih_params;`` directive emits a ``#[derive(Params)]`` struct of
``FloatParam``s from the graph's value inputs plus a ``sync_to(graph)``
per-block applier (oscen-graph-compiler codegen/mod.rs:981-1152).  This
module is that struct: :func:`nih_params` builds a :class:`NihParams`
from a :class:`~oscen_tpu_torch.graph.builder.Graph`'s
``param_specs()``, with the same semantics:

- range: ``Linear{min, max}`` (default 0..1) or ``Skewed`` when the spec
  has a ``center`` — the skew factor is chosen so the center sits at
  normalized 0.5 (``factor = log_base((center-min)/(max-min)) of 0.5``,
  codegen/mod.rs:1032-1046);
- ``display_name`` defaults to Title-Cased snake_case (:1008-1023);
- ``step`` quantizes values (:1099-1105);
- ``unit`` is carried for display (:1088-1097);
- ``smoother: ms`` requests linear smoothing, honored only when the input
  is NOT ramped (ramped inputs already smooth through the graph's
  ValueRampState, :1074-1086);
- ``sync_to(compiled)`` applies every param once per block: ramped inputs
  through the generated ramp setter, smoothed inputs as a
  ``smoother_ms``-long ramp, the rest immediately (:1112-1127).
"""

from __future__ import annotations

import math
from typing import Dict

from ..core.types import Kind, ParamSpec

__all__ = ["FloatParam", "NihParams", "nih_params"]


def _title_case(name: str) -> str:
    return " ".join(w[:1].upper() + w[1:] for w in name.split("_") if w)


class FloatParam:
    """One host parameter: normalized<->value mapping with optional skew,
    step quantization, unit, and smoothing metadata."""

    def __init__(self, name: str, default: float, spec: ParamSpec):
        self.name = name
        self.spec = spec
        self.display_name = spec.display_name or _title_case(name)
        self.min = float(spec.min) if spec.min is not None else 0.0
        self.max = float(spec.max) if spec.max is not None else 1.0
        if not (self.max > self.min):
            raise ValueError(f"param '{name}': max must exceed min")
        self.unit = spec.unit or ""
        self.step = float(spec.step) if spec.step is not None else None
        self.smoother_ms = (float(spec.smoother_ms)
                            if spec.smoother_ms is not None else None)
        self.ramp_frames = int(spec.ramp_frames or 0)
        # skew factor: normalized 0.5 lands exactly on `center`
        # (codegen/mod.rs:1032-1046: factor = 0.5.log((c-min)/(max-min)))
        self.factor = 1.0
        center = spec.center
        if center is None and spec.log:
            # log curve without explicit center: geometric midpoint
            if self.min > 0:
                center = math.sqrt(self.min * self.max)
        if center is not None:
            frac = (float(center) - self.min) / (self.max - self.min)
            if not (0.0 < frac < 1.0):
                raise ValueError(
                    f"param '{name}': center must lie strictly inside "
                    f"[min, max]")
            self.factor = math.log(0.5) / math.log(frac)
        self.default = self._quantize(float(default))
        self._value = self.default

    # -- range mapping (nih FloatRange::Skewed semantics) ---------------- #
    def normalize(self, value: float) -> float:
        frac = (min(max(value, self.min), self.max) - self.min) \
            / (self.max - self.min)
        return frac ** self.factor

    def unnormalize(self, normalized: float) -> float:
        n = min(max(float(normalized), 0.0), 1.0)
        return n ** (1.0 / self.factor) * (self.max - self.min) + self.min

    def _quantize(self, value: float) -> float:
        value = min(max(float(value), self.min), self.max)
        if self.step:
            value = self.min + round((value - self.min) / self.step) \
                * self.step
            value = min(max(value, self.min), self.max)
        return value

    # -- host API --------------------------------------------------------- #
    def value(self) -> float:
        return self._value

    def set_value(self, value: float) -> None:
        self._value = self._quantize(value)

    def normalized(self) -> float:
        return self.normalize(self._value)

    def set_normalized(self, normalized: float) -> None:
        self._value = self._quantize(self.unnormalize(normalized))

    def __repr__(self):
        unit = f" {self.unit}" if self.unit else ""
        return (f"FloatParam({self.name!r}, {self._value:g}{unit}, "
                f"range=[{self.min:g}, {self.max:g}], "
                f"factor={self.factor:g})")


class NihParams:
    """The generated params struct: one FloatParam per value input."""

    def __init__(self, params: Dict[str, FloatParam]):
        self._params = dict(params)

    def __getattr__(self, name: str) -> FloatParam:
        try:
            return self._params[name]
        except KeyError:
            raise AttributeError(name) from None

    def __getitem__(self, name: str) -> FloatParam:
        return self._params[name]

    def __iter__(self):
        return iter(self._params.values())

    def names(self):
        return list(self._params)

    def sync_to(self, compiled) -> None:
        """Apply every parameter to the compiled graph — call once per
        block (codegen/mod.rs:1112-1127 / simple-echo lib.rs)."""
        sr = compiled.sample_rate
        for p in self._params.values():
            if p.name not in compiled._params:
                continue
            if p.ramp_frames:
                compiled.set_value(p.name, p.value())  # declared ramp
            elif p.smoother_ms:
                frames = max(int(round(p.smoother_ms * sr / 1000.0)), 1)
                compiled.set_value_with_ramp(p.name, p.value(), frames)
            else:
                compiled.set_value_immediate(p.name, p.value())


def nih_params(graph) -> NihParams:
    """Build the params struct from a Graph's value inputs (the
    ``nih_params;`` directive)."""
    params = {}
    for inp in graph._inputs:
        if inp.kind != Kind.VALUE:
            continue
        params[inp.name] = FloatParam(inp.name, float(inp.default),
                                      inp.spec or ParamSpec())
    return NihParams(params)
