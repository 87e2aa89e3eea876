"""Sequential-in-time, parallel-in-voice IIR scans: CUDA kernels and plain
versions.

Counterpart of ``oscen_tpu/ops/pallas/iir.py``; holds the TPT SVF lowpass,
the LP18 (three poles, the first through ``tanh``), the DF-II-T biquad and
the first-order allpass cascade of the IIR-halfband resampler.  Each keeps
the reference's per-sample op order, so the output is bit-identical across
block sizes:

- ``tpt_svf_scan``: filters/tpt/mod.rs:108-123;
- ``lp18_scan``: nih-twin-peaks/src/lp18_filter.rs, with ``tanh`` evaluated
  in float64 and rounded once (``ops/fmath.py``), so the CPU and the card
  give the same float32 values;
- ``biquad_scan``: iir_lowpass/mod.rs:109-132 with the reference tick's
  denormal snaps: ``|x|``, ``|v1|`` and ``|v2|`` below
  ``DENORMAL_THRESHOLD`` become 0 (the Pallas kernel leaves them out
  because the TPU flushes denormals; the card and the CPU keep them);
- ``allpass_cascade_scan``: resample/halfband_iir.rs:24-63, S stages of
  ``y = a*(x - y_prev) + x_prev`` chained within the sample.

Every coefficient of the first three is a ``[V]`` row (block-constant) or
a ``[B, V]`` per-sample plane; the kernels take a time stride of 0 or V for
each (the biquad's kernel all five alike: ``biquad_scan`` expands the rows
of a mixed call into planes on the card).  The allpass cascade takes
``[S, V]`` rows.

Selection: a CPU tensor runs the plain version, a CUDA tensor runs the
kernel of ``csrc/iir.cu`` (built at first use) or raises.  ``launches``
counts each kernel's launches; the plain versions are not counted.

On the card ``lp18_scan`` evaluates the ``tanh`` and the division by short
exact paths (``csrc/iir.cu``: ``tanh_exact_fast``, ``div_by``);
``tanh_exact``, ``tanh_exact_sweep`` and ``div_sweep`` hold them to the
float64 ``tanh`` rounded once and to the true quotient.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import fmath

KERNELS = ("tpt_svf_scan", "lp18_scan", "biquad_scan",
           "allpass_cascade_scan")
launches: Dict[str, int] = {k: 0 for k in KERNELS}

DENORMAL_THRESHOLD = 1e-15


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check_shapes(name, x, coefs, states):
    """``x`` ``[B, V]``; each coefficient ``[V]`` or ``[B, V]``; each state
    its given shape.  Returns (B, V)."""
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [B, V] (got {tuple(x.shape)})")
    B, V = x.shape
    for nm, c in coefs.items():
        if tuple(c.shape) not in ((V,), (B, V)):
            raise ValueError(f"{name}: {nm} must be [{V}] or [{B}, {V}] "
                             f"(got {tuple(c.shape)})")
    for nm, (z, rows) in states.items():
        want = (V,) if rows is None else (rows, V)
        if tuple(z.shape) != want:
            raise ValueError(f"{name}: {nm} must be {list(want)} (got "
                             f"{tuple(z.shape)})")
    return B, V


def _launch(name, symbol, x, ins, outs, V, B, strides):
    """Launch ``csrc/iir.cu``'s ``symbol`` on ``x``'s stream: pointers of
    ``ins`` then ``outs``, then V, B and the coefficients' time strides."""
    from . import build
    build.check_operands(x.device, **ins)
    fn = build.entry("iir", symbol, len(ins) + len(outs), 2 + len(strides))
    rc = fn(*[t.data_ptr() for t in ins.values()],
            *[t.data_ptr() for t in outs], V, B, *strides,
            torch.cuda.current_stream(x.device).cuda_stream)
    launches[name] += 1
    build.check_launch("iir", rc, name)


def _route(name, x):
    """True for the plain version (a CPU tensor), False for the kernel."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {x.device}")
    return False


def _rows(*coefs):
    """Each coefficient at sample ``t``: the row itself, or plane ``[t]``."""
    return [(c, c.dim() == 1) for c in coefs]


def _at(rows, t):
    return [c if row else c[t] for c, row in rows]


# --------------------------------------------------------------------- #
def tpt_svf_scan(x, h, g, k, z0, z1):
    """Zavalishin TPT SVF lowpass over a block, voice-parallel.

    Args: ``x`` ``[B, V]`` time-major; ``h``/``g``/``k`` each ``[V]``
    (block-constant) or ``[B, V]`` (per-sample); ``z0``/``z1`` ``[V]``.
    Returns (``y`` ``[B, V]``, ``z0'``, ``z1'``).
    """
    B, V = _check_shapes("tpt_svf_scan", x, {"h": h, "g": g, "k": k},
                         {"z0": (z0, None), "z1": (z1, None)})
    if _route("tpt_svf_scan", x):
        return plain_tpt_svf_scan(x, h, g, k, z0, z1)
    y = torch.empty_like(x)
    z0o = torch.empty_like(z0)
    z1o = torch.empty_like(z1)
    _launch("tpt_svf_scan", "oscen_tpt_svf_scan", x,
            dict(x=x, h=h, g=g, k=k, z0=z0, z1=z1), (y, z0o, z1o), V, B,
            [V if c.dim() == 2 else 0 for c in (h, g, k)])
    return y, z0o, z1o


def plain_tpt_svf_scan(x, h, g, k, z0, z1):
    """The kernel's per-sample loop in plain PyTorch, over ``[V]`` rows."""
    y = torch.empty_like(x)
    rows = _rows(h, g, k)
    for t in range(x.shape[0]):
        ht, gt, kt = _at(rows, t)
        high = (x[t] - z0 * kt - z1) * ht
        band = high * gt + z0
        low = band * gt + z1
        z0 = high * gt + band
        z1 = band * gt + low
        y[t] = low
    return y, z0, z1


# --------------------------------------------------------------------- #
def lp18_scan(x, g, h, z):
    """LP18 (three poles, a ``tanh`` first pole) over a block,
    voice-parallel.

    Args: ``x`` ``[B, V]`` time-major; ``g``/``h`` each ``[V]`` or
    ``[B, V]``; ``z`` ``[3, V]`` pole states.  Returns (``y`` ``[B, V]``,
    ``z'`` ``[3, V]``).
    """
    B, V = _check_shapes("lp18_scan", x, {"g": g, "h": h}, {"z": (z, 3)})
    if _route("lp18_scan", x):
        return plain_lp18_scan(x, g, h, z)
    y = torch.empty_like(x)
    zo = torch.empty_like(z)
    _launch("lp18_scan", "oscen_lp18_scan", x, dict(x=x, g=g, h=h, z=z),
            (y, zo), V, B, [V if c.dim() == 2 else 0 for c in (g, h)])
    return y, zo


def plain_lp18_scan(x, g, h, z):
    """The kernel's per-sample loop in plain PyTorch, over ``[V]`` rows:
    ``hp = (x - h*z0 - z1 - z2) / (1 + g)``, ``z0 = tanh(g*hp + z0)``
    (float64 ``tanh``, rounded once), ``z1 = g*bp1 + z1``,
    ``z2 = y = g*bp2 + z2``."""
    y = torch.empty_like(x)
    z0, z1, z2 = z[0], z[1], z[2]
    rows = _rows(g, h)
    for t in range(x.shape[0]):
        gt, ht = _at(rows, t)
        hp = (x[t] - ht * z0 - z1 - z2) / (1.0 + gt)
        bp1 = gt * hp + z0
        z0 = fmath.tanh(bp1)
        bp2 = gt * bp1 + z1
        z1 = bp2
        z2 = gt * bp2 + z2
        y[t] = z2
    return y, torch.stack([z0, z1, z2])


def _counts(dev):
    return torch.zeros(2, dtype=torch.int64, device=dev)


def _card_only(name, dev):
    if dev.type != "cuda":
        raise ValueError(f"{name} checks the card's kernels: give it a CUDA "
                         f"device (got {dev})")


def tanh_exact(b):
    """``(float)tanh((double)b)`` by K8's short path: (``y``, the count
    of inputs its rounding test left undecided, which took the float64
    ``tanh``).  On the CPU: ``fmath.tanh`` and the count of
    ``tanh_table.model``."""
    if b.device.type == "cpu":
        from . import tanh_table
        from .build import CSRC_DIR
        coef = tanh_table.parse((CSRC_DIR / "tanh_table.cuh").read_text())
        _, kept = tanh_table.model(b.numpy(), coef)
        return fmath.tanh(b), int((~kept).sum())
    from . import build
    _card_only("tanh_exact", b.device)
    build.check_operands(b.device, b=b)
    y, counts = torch.empty_like(b), _counts(b.device)
    fn = build.entry("iir", "oscen_tanh_exact_map", 3, 1)
    build.check_launch("iir", fn(b.data_ptr(), y.data_ptr(),
                                 counts.data_ptr(), b.numel(),
                                 torch.cuda.current_stream(b.device)
                                 .cuda_stream), "tanh_exact")
    return y, int(counts[1])


def tanh_exact_sweep(device="cuda"):
    """K8's ``tanh`` over all 2^32 float32 bit patterns on the card:
    (patterns where it differs from ``(float)tanh((double)b)``, NaN equal
    to NaN; patterns its rounding test left undecided; the first differing
    pattern, or None)."""
    from . import build
    dev = torch.device(device)
    _card_only("tanh_exact_sweep", dev)
    counts = torch.tensor([0, 0, -1], dtype=torch.int64, device=dev)
    fn = build.entry("iir", "oscen_tanh_exact_sweep", 1, 0)
    build.check_launch("iir", fn(counts.data_ptr(), torch.cuda.current_stream(
        dev).cuda_stream), "tanh_exact_sweep")
    wrong, undecided, first = counts.tolist()
    return wrong, undecided, (first & 0xFFFFFFFF) if wrong else None


def div_sweep(d):
    """K8's division over every finite float32 ``a`` and each divisor of
    ``d`` (a CUDA tensor): the pairs where it differs from ``a / d`` bit for
    bit."""
    from . import build
    _card_only("div_sweep", d.device)
    build.check_operands(d.device, d=d)
    counts = _counts(d.device)
    fn = build.entry("iir", "oscen_div_sweep", 2, 1)
    build.check_launch("iir", fn(d.data_ptr(), counts.data_ptr(), d.numel(),
                                 torch.cuda.current_stream(d.device)
                                 .cuda_stream), "div_sweep")
    return int(counts[0])


# --------------------------------------------------------------------- #
def biquad_scan(x, b0, b1, b2, a1, a2, v1, v2):
    """DF-II-T biquad over a block, voice-parallel, with the reference
    tick's denormal snaps on ``x``, ``v1`` and ``v2``.

    Args: ``x`` ``[B, V]`` time-major; ``b0 b1 b2 a1 a2`` each ``[V]`` or
    ``[B, V]``; ``v1``/``v2`` ``[V]``.  Returns (``y`` ``[B, V]``, ``v1'``,
    ``v2'``).
    """
    coefs = {"b0": b0, "b1": b1, "b2": b2, "a1": a1, "a2": a2}
    B, V = _check_shapes("biquad_scan", x, coefs,
                         {"v1": (v1, None), "v2": (v2, None)})
    if _route("biquad_scan", x):
        return plain_biquad_scan(x, b0, b1, b2, a1, a2, v1, v2)
    if len({c.dim() for c in coefs.values()}) > 1:
        # the kernel takes every coefficient as a row or every one as a
        # plane: a mixed call's rows become planes, on the card
        coefs = {k: c.expand(B, V).contiguous() if c.dim() == 1 else c
                 for k, c in coefs.items()}
    y = torch.empty_like(x)
    v1o = torch.empty_like(v1)
    v2o = torch.empty_like(v2)
    _launch("biquad_scan", "oscen_biquad_scan", x,
            dict(x=x, **coefs, v1=v1, v2=v2), (y, v1o, v2o), V, B,
            [V if c.dim() == 2 else 0 for c in coefs.values()])
    return y, v1o, v2o


def _snap(v):
    """``v`` with ``|v| < DENORMAL_THRESHOLD`` set to 0 (the reference's
    snap, iir_lowpass/mod.rs)."""
    return torch.where(torch.abs(v) < DENORMAL_THRESHOLD,
                       torch.zeros_like(v), v)


def plain_biquad_scan(x, b0, b1, b2, a1, a2, v1, v2):
    """The kernel's per-sample loop in plain PyTorch, over ``[V]`` rows."""
    y = torch.empty_like(x)
    rows = _rows(b0, b1, b2, a1, a2)
    for t in range(x.shape[0]):
        c0, c1, c2, d1, d2 = _at(rows, t)
        xt = _snap(x[t])
        out = c0 * xt + v1
        v1 = _snap(c1 * xt - d1 * out + v2)
        v2 = _snap(c2 * xt - d2 * out)
        y[t] = out
    return y, v1, v2


# --------------------------------------------------------------------- #
def allpass_cascade_scan(x, a, xp, yp):
    """One block through an S-stage first-order allpass cascade,
    lane-parallel (the branch of the IIR-halfband resampler;
    ``_allpass_kernel`` of ``oscen_tpu/ops/pallas/iir.py``).

    Args: ``x`` ``[B, V]`` time-major; ``a``, ``xp``, ``yp`` ``[S, V]``:
    each stage's coefficient and its input and output histories, per lane
    (so one launch may carry lanes with different coefficients, e.g. both
    branches of a halfband stage).  Returns (``y`` ``[B, V]``, ``xp'``,
    ``yp'``).  On the card, ``csrc/iir.cu``'s ``allpass_kernel`` keeps every
    stage in registers; it is bound by the serial chain of 3·S dependent
    float ops per sample step, not by bytes.
    """
    if x.dim() != 2 or a.dim() != 2:
        raise ValueError(f"allpass_cascade_scan: x must be [B, V] and a "
                         f"[S, V] (got {tuple(x.shape)}, {tuple(a.shape)})")
    S, V = a.shape
    if x.shape[1] != V or not 1 <= S <= 8:
        raise ValueError(f"allpass_cascade_scan: a must be [S, {x.shape[1]}]"
                         f" with 1 <= S <= 8 (got {tuple(a.shape)})")
    B, V = _check_shapes("allpass_cascade_scan", x, {},
                         {"xp": (xp, S), "yp": (yp, S)})
    if _route("allpass_cascade_scan", x):
        return plain_allpass_cascade_scan(x, a, xp, yp)
    y = torch.empty_like(x)
    xpo = torch.empty_like(xp)
    ypo = torch.empty_like(yp)
    _launch("allpass_cascade_scan", "oscen_allpass_cascade_scan", x,
            dict(x=x, a=a, xp=xp, yp=yp), (y, xpo, ypo), V, B, [S])
    return y, xpo, ypo


def plain_allpass_cascade_scan(x, a, xp, yp):
    """The kernel's per-sample loop in plain PyTorch, over ``[V]`` rows:
    per stage ``y = a*(x - yp) + xp``, then ``xp = x``, ``yp = y``."""
    y = torch.empty_like(x)
    coef = list(a.unbind(0))
    xps, yps = list(xp.unbind(0)), list(yp.unbind(0))
    for t in range(x.shape[0]):
        cur = x[t]
        for s in range(len(coef)):
            out = coef[s] * (cur - yps[s]) + xps[s]
            xps[s], yps[s], cur = cur, out, out
        y[t] = cur
    return y, torch.stack(xps), torch.stack(yps)
