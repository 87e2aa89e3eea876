"""The FM operator's sine, in turns.

Counterpart of ``oscen_tpu/ops/fastmath.py``.  :func:`sin_turns` is the
operator sine on every path of the FM nodes: the plain versions of the FM
kernels, the zero-feedback fast branches and, as the same polynomial in
``csrc/fm.cu``, the CUDA kernels.  Feedback FM amplifies any per-sample
difference chaotically, so one shared definition is what keeps the paths
bit-compatible.

Op order is the JAX package's: ``w = x - round(x)`` with round half to
even (``torch.round``; ``rintf`` in CUDA, never ``roundf``), ``u = w*w``,
Horner ``acc = acc*u + c`` from the highest coefficient down, ``acc*w``.
The coefficients are the float32 roundings of :data:`SIN_TURNS_COEFFS`.
:func:`sin_turns` rounds every product and sum, as the JAX function does
when it runs eagerly; :func:`sin_turns_fma` is the same polynomial as XLA
compiles it inside a jitted graph (the fused chains' ticks), each Horner
step one fused multiply-add.
"""

from __future__ import annotations

import numpy as np
import torch

from .fmath import fma

# odd degree-9 polynomial coefficients for sin(2*pi*w), w in [-1/2, 1/2]
# (the JAX package's equal-ripple fit; float32 max error 1.38e-5)
SIN_TURNS_COEFFS = (
    6.283080764252614,
    -41.33275295303292,
    81.39177500890156,
    -74.62526956566208,
    33.06713168909331,
)
# the float32 values the arithmetic uses (csrc/fm.cu holds the same as hex)
SIN_TURNS_F32 = tuple(float(np.float32(c)) for c in SIN_TURNS_COEFFS)


def sin_turns(x):
    """``sin(2*pi*x)`` for ``x`` in turns (cycles), any magnitude."""
    w = x - torch.round(x)
    u = w * w
    acc = u * SIN_TURNS_F32[4]
    acc = acc + SIN_TURNS_F32[3]
    for k in (2, 1, 0):
        acc = acc * u + SIN_TURNS_F32[k]
    return acc * w


def sin_turns_fma(x):
    """:func:`sin_turns` with each Horner step ``acc*u + c`` rounded once
    (``fmath.fma``; ``__fmaf_rn`` in CUDA), as XLA contracts it."""
    w = x - torch.round(x)
    u = w * w
    acc = fma(u, SIN_TURNS_F32[4], SIN_TURNS_F32[3])
    for k in (2, 1, 0):
        acc = fma(acc, u, SIN_TURNS_F32[k])
    return acc * w
