"""Float32 math that rounds the same on the CPU and the card.

PyTorch's float32 ``sin``/``cos``/``tan``/``tanh``/``exp``/``log``/``pow``
differ between its CPU and CUDA implementations by an ulp here and there.
On the additive voice that matters: a rotation multiplier that differs by
an ulp drifts the oscillator's phase linearly in time; the 256-voice piano
rendered 7.5e-3 apart (peak 190) on an H100 and on the CPU over its first
four 1024-sample blocks, and 3e-5 apart with this module.  Evaluated in
float64 and rounded once, the results are the correctly rounded float32
values on both (the arguments stay float32, as in the JAX package).  The
operands here are small (``[C, H]`` planes, ``[B]`` rows); the LP18's
``tanh`` runs per sample inside its scan, as ``(float)tanh((double)x)`` in
``csrc/iir.cu``.

Division by a constant has the same problem: on CUDA, PyTorch computes
``tensor / python_float`` as a product with the float32 reciprocal, on the
CPU as a true quotient; the two differ by an ulp for most divisors (9 of
the 32 harmonic rotation angles of a 440 Hz note at 48 kHz).  Each form
below is computed the same way on both devices:

- :func:`div`, the true quotient, as the JAX package's node functions give
  it when they run eagerly (the electric-piano nodes are held to those);
- :func:`div_const`, the product with the float32 reciprocal, as the JAX
  package gives it inside a ``CompiledGraph``: XLA rewrites ``x / c`` for
  a constant ``c`` into ``x * float32(1 / c)`` under ``jit``.  The
  poly-synth nodes use it, because an oscillator's per-sample increment
  ``f / sr`` accumulates into its phase, and one ulp there drifts the
  phase away from the JAX package's compiled graph;
- :func:`rdiv`, a constant divided by a tensor, a true quotient under
  ``jit`` too (PyTorch's ``python_float / tensor`` is a reciprocal times
  the constant, two roundings).
"""

from __future__ import annotations

import numpy as np
import torch


def sin(x):
    return torch.sin(x.double()).float()


def cos(x):
    return torch.cos(x.double()).float()


def tan(x):
    return torch.tan(x.double()).float()


def tanh(x):
    return torch.tanh(x.double()).float()


def exp(x):
    return torch.exp(x.double()).float()


def log(x):
    return torch.log(x.double()).float()


def pow(x, y):
    return torch.pow(x.double(), y.double()).float()


def div(x, c: float):
    """``x / c`` correctly rounded on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def inv_const(c: float) -> float:
    """The float32 reciprocal of ``c`` that XLA multiplies by for
    ``x / c`` (a Python float holding a float32 value)."""
    return float(np.float32(1.0) / np.float32(c))


def div_const(x, c: float):
    """``x / c`` as XLA compiles it: ``x`` times the float32 reciprocal of
    ``c``, one rounding, the same on every device."""
    return x * inv_const(c)


def rdiv(c: float, x):
    """``c / x`` correctly rounded on every device, as in XLA."""
    return torch.full((), c, dtype=x.dtype, device=x.device) / x


def fma(a, b, c):
    """``a*b + c`` on float32 operands with ONE rounding, the same on every
    device: what XLA's CPU backend computes where it contracts a product
    that feeds a sum, and ``__fmaf_rn`` on the card.  Any operand but one
    tensor may be a Python float holding a float32 value; the operands
    broadcast.

    The float64 product of two float32 values is exact.  The float64 sum
    ``s`` is rounded to odd before the final rounding to float32, so that
    rounding is the correct one, never a double rounding: TwoSum gives the
    sum's exact error, and an inexact ``s`` is truncated toward zero and
    its last bit set (one step in the int64 view of the float64 bits)."""
    a, b, c = (x.double() if isinstance(x, torch.Tensor) else float(x)
               for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    e = err * s          # > 0: the exact sum lies beyond s, < 0: inside it
    inside = e < 0
    bits = ((s.view(torch.int64) - inside.long())
            | (inside | (e > 0)).long())
    return bits.view(torch.float64).float()
