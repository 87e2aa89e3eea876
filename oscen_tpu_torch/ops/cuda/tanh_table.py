"""The coefficient table of ``csrc/iir.cu``'s ``tanh_exact`` and a numpy
model of its fast path.

``tanh_exact(b)`` returns exactly ``(float)tanh((double)b)``, the float64
``tanh`` rounded once, which is what ``ops/fmath.py::tanh`` gives on the
CPU and on the card.  Its fast path:

- ``a = |b|``; ``a >= SATURATION`` gives ``copysign(1, b)``: the smallest
  float32 whose ``tanh`` rounds to 1;
- interval ``i = round(16 min(a, 9))`` (centre ``i / 16``, half-width 1/32),
  ``r = a - i / 16`` (exact in float32; ``r = a`` in interval 0), and a
  degree-7 polynomial in ``r`` in float64: in interval 0 the odd
  polynomial ``a + a**3 * R(a*a)`` (``R`` a Chebyshev interpolation of
  ``(tanh(a) / a - 1) / a**2`` in ``a*a``, so tiny and denormal ``a`` keep
  their relative accuracy), in every other interval a Chebyshev
  interpolation of ``tanh`` in the power basis;
- the value ``t`` rounds to ``y = float32(t)``, and Ziv's rounding test
  reads ``t``'s bits: the 29 low bits of its significand are the part
  below ``y``'s last place, and it keeps ``y`` unless they lie within
  ``MARGIN`` units (of ``t``'s last place) of the half-way pattern 2**28.
  The margin covers the table's error (below 2**-48 relative, measured
  against 120-bit ``tanh``), the float64 evaluation (a few 2**-53) and
  libdevice's own error (1 ulp of float64), under 30 units together, so
  every value the test keeps is the one the float64 ``tanh`` rounds to.
  Where ``t`` falls in float32's denormal range it is a float32 itself
  (``tanh(a)`` rounds to ``a`` there).  NaN and every undecided input go
  to the fallback, the float64 ``tanh`` itself.

``python -m oscen_tpu_torch.ops.cuda.tanh_table`` prints the header
``csrc/tanh_table.cuh``; ``tests/test_torch_tanh_exact.py`` holds the header to
this generator and the model to ``fmath.tanh``.
"""

from __future__ import annotations

import numpy as np
from numpy.polynomial import chebyshev as cheb
from numpy.polynomial import polynomial as poly

STEP = 1.0 / 16          # interval width; centres i * STEP
DEGREE = 7               # 8 coefficients per interval
MARGIN = 256             # Ziv's margin, in units of t's last place


def saturation() -> float:
    """The smallest float32 ``a`` with ``float32(tanh(float64(a))) == 1``:
    ``tanh(a) >= 1 - 2**-25`` above ``atanh(1 - 2**-25)``."""
    a = np.float32(0.5 * np.log((2.0 - 2.0 ** -25) / 2.0 ** -25))
    while np.float32(np.tanh(np.float64(a))) == 1.0:
        a = np.nextafter(a, np.float32(0))
    while np.float32(np.tanh(np.float64(a))) != 1.0:
        a = np.nextafter(a, np.float32(np.inf))
    return float(a)


SATURATION = saturation()
INTERVALS = int(round(SATURATION / STEP)) + 1


def coefficients() -> np.ndarray:
    """``[INTERVALS, 8]`` float64, power-basis coefficients in ``r``: row 0
    ``[0, 1, 0, R0, 0, R1, 0, R2]``, row ``i`` those of ``tanh(i * STEP +
    r)``."""
    half = STEP / 2
    smax = half * half

    def rem(x):   # (tanh(a)/a - 1) / a^2 at a^2 = s, by its series below 1e-4
        sq = (x + 1) / 2 * smax
        a = np.sqrt(sq)
        series = -1 / 3 + sq * (2 / 15 - sq * (17 / 315 - sq * 62 / 2835))
        with np.errstate(invalid="ignore", divide="ignore"):
            exact = (np.tanh(a) / a - 1) / sq
        return np.where(sq < 1e-4, series, exact)
    r0 = poly.Polynomial(cheb.cheb2poly(cheb.chebinterpolate(rem, 2)))(
        poly.Polynomial([-1.0, 2.0 / smax])).coef
    rows = [np.array([0.0, 1.0, 0.0, r0[0], 0.0, r0[1], 0.0, r0[2]])]
    for i in range(1, INTERVALS):
        c = i * STEP
        ch = cheb.chebinterpolate(lambda u: np.tanh(c + u * half), DEGREE)
        p = poly.Polynomial(cheb.cheb2poly(ch))(
            poly.Polynomial([0.0, 1.0 / half]))
        rows.append(np.pad(p.coef, (0, DEGREE + 1 - len(p.coef))))
    return np.stack(rows)


def render(coef: np.ndarray | None = None) -> str:
    """The header ``csrc/tanh_table.cuh`` as text."""
    coef = coefficients() if coef is None else coef
    lines = [
        "// Generated by `python -m oscen_tpu_torch.ops.cuda.tanh_table`: "
        "do not edit.",
        "// tanh_exact's table (ops/cuda/tanh_table.py): row i the degree-7",
        "// polynomial of tanh(i/16 + r) in r, |r| <= 1/32 (row 0 odd, its",
        "// linear term 1); float64, c0 first.",
        "#pragma once",
        "",
        f"#define OSCEN_TANH_INTERVALS {INTERVALS}",
        f"#define OSCEN_TANH_SATURATION {float(SATURATION).hex()}f",
        f"#define OSCEN_TANH_MARGIN {MARGIN}",
        "",
        "__device__ __align__(16) double kTanhCoef[OSCEN_TANH_INTERVALS * 8] "
        "= {",
    ]
    for i, row in enumerate(coef):
        vals = ", ".join(float(v).hex() for v in row)
        lines.append(f"    {vals},  // {i}")
    lines.append("};")
    return "\n".join(lines) + "\n"


def parse(text: str) -> np.ndarray:
    """The table of a rendered header, ``[INTERVALS, 8]``."""
    body = text.split("= {", 1)[1].split("};", 1)[0]
    vals = [float.fromhex(tok.strip()) for ln in body.splitlines()
            for tok in ln.split("//")[0].split(",") if tok.strip()]
    return np.asarray(vals).reshape(-1, DEGREE + 1)


def model(b: np.ndarray, coef: np.ndarray):
    """The fast path on float32 ``b``: (y, kept).  ``kept`` is False where
    the kernel takes the fallback (the rounding test could not decide, or
    NaN).  Evaluated in float64 as the kernel does, but without its fused
    multiply-adds: the two differ by a few 2**-53, inside the margin."""
    b = np.asarray(b, np.float32)
    a = np.abs(b)
    with np.errstate(invalid="ignore", over="ignore"):
        f = np.minimum(a, np.float32(9.0)) + np.float32(2.0 ** 19)
        c = f - np.float32(2.0 ** 19)
        r = (a - c).astype(np.float64)
        i = np.where(np.isnan(a), 0, f.view(np.int32) - np.int32(0x49000000))
        u = r
        k = coef[i]
        u2 = u * u
        p01 = k[:, 1] * u + k[:, 0]
        p23 = k[:, 3] * u + k[:, 2]
        p45 = k[:, 5] * u + k[:, 4]
        p67 = k[:, 7] * u + k[:, 6]
        t = (p67 * u2 + p45) * (u2 * u2) + (p23 * u2 + p01)
        y = t.astype(np.float32)
        below = (t.view(np.uint64) & np.uint64(0x1FFFFFFF)).astype(np.int64)
        near = np.abs(below - 0x10000000) < MARGIN
        sat = a >= np.float32(SATURATION)
        kept = sat | ~(near | np.isnan(t))
        y = np.where(sat, np.float32(1.0), y)
    return np.copysign(y, b).astype(np.float32), kept


if __name__ == "__main__":
    print(render(), end="")
