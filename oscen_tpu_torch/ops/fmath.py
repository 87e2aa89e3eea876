"""Float32 math that rounds the same on the CPU and the card.

PyTorch's float32 ``sin``/``cos``/``exp``/``log``/``pow`` differ between
its CPU and CUDA implementations by an ulp here and there.  On the additive
voice that matters: a rotation multiplier that differs by an ulp drifts the
oscillator's phase linearly in time; the 256-voice piano rendered 7.5e-3
apart (peak 190) on an H100 and on the CPU over its first four
1024-sample blocks, and 3e-5 apart with this module.
Evaluated in float64 and rounded once, the results are the correctly
rounded float32 values on both (the arguments stay float32, as in the JAX
package).  The operands here are small (``[C, H]`` planes, ``[B]`` rows).

Division by a constant has the same problem: on CUDA, PyTorch computes
``tensor / python_float`` as a product with the float32 reciprocal, which
is an ulp off the quotient for most divisors (9 of the 32 harmonic
rotation angles of a 440 Hz note at 48 kHz).  :func:`div` divides by a
0-d tensor instead, which both devices divide correctly rounded.
"""

from __future__ import annotations

import torch


def sin(x):
    return torch.sin(x.double()).float()


def cos(x):
    return torch.cos(x.double()).float()


def exp(x):
    return torch.exp(x.double()).float()


def log(x):
    return torch.log(x.double()).float()


def pow(x, y):
    return torch.pow(x.double(), y.double()).float()


def div(x, c: float):
    """``x / c`` correctly rounded on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)
