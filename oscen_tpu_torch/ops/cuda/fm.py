"""FM operator recurrences: CUDA kernels and plain versions.

Counterpart of ``oscen_tpu/ops/pallas/fm.py``.  An FM operator with
self-feedback (``prev_output * feedback`` into its phase) is a one-sample
nonlinear recurrence, so each kernel replays the exact per-sample op order
with voices in lanes:

- :func:`fract_phase3`: the three chain operators' phases, ``p += dt;
  p -= trunc(p)`` (Rust ``.fract()``), block-constant dt;
- :func:`fm_chain3_scan`: the fm-synth voice's chain op3 → op2 → op1 with
  the route crossfade (``FmOperatorChain``);
- :func:`pivot_chain3_scan`: the pivot voice's chain, the raw sine as the
  feedback carry and the enveloped signal as the modulation
  (``PivotOperatorChain``);
- :func:`fm_operator_scan`: one operator (``FmOperator``).

The chains fold each operator's level into its envelope stream first
(``env * lvl``, one ``[B, V]`` product each).  A block whose dt is
block-constant, whose length is a multiple of 8 and whose feedbacks are all
0 takes the zero-feedback branch: :func:`fract_phase3` plus the sines and
the routing vectorized over the whole block in plain PyTorch.  The caller
says whether the feedbacks are 0 (``fb_zero``), from values it knows on the
host; nothing here reads the card.  The two branches compute the same
float32 expressions in the same order (``prev * 0`` adds an exact zero in
the sequential one), so they are bit-equal.  On the card the pivot's
chain runs its sequential kernel for such a block too: the branch's fused
multiply-adds would each be a float64 emulation of a dozen and more
PyTorch ops (``fmath.fma``), where the kernel gives the same bits in one
launch.

Phase steps and contractions.  The chains' phases step by
``fma(dt, inv_sr, p)``: with ``inv_sr=1`` that is ``p + dt`` exactly (the
Pallas kernels' step); the pivot passes ``dt = base_freq*ratio`` and the
float32 reciprocal of the rate, as XLA compiles the JAX pivot graph's
``p + f*ratio/sr`` into one FMA.  The pivot chain rounds as XLA compiles
the JAX pivot tick throughout (bit for bit against a jitted scan of it):
each operator's argument is ``fma(prev, fb, ph + pm)``, op2's ``ph + a``
is ``fma(a3, 1 - route, ph2)``, op1's modulation ``a2 + b`` is
``fma(a3, route, a2)``, and the sine is :func:`sin_turns_fma`.  The fm
chain and the lone operator round every product and sum: in the JAX fm
synth's graph XLA leaves the phase step uncontracted (measured on the
CPU), so nothing there is fused.  The fused multiply-adds are
``fmath.fma`` here and ``__fmaf_rn`` in ``csrc/fm.cu``.

Selection: a CPU tensor runs the plain version, a CUDA tensor runs the
kernel of ``csrc/fm.cu`` (built at first use) or raises.  ``launches``
counts each kernel's launches; the plain versions are not counted.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..fastmath import sin_turns, sin_turns_fma
from ..fmath import fma

FRACT = "fract_phase3"
FM_CHAIN = "fm_chain3_scan"
PIVOT_CHAIN = "pivot_chain3_scan"
OPERATOR = "fm_operator_scan"
KERNELS = (FRACT, FM_CHAIN, PIVOT_CHAIN, OPERATOR)
launches: Dict[str, int] = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


def _device_of(t, name: str) -> str:
    if t.device.type == "cpu":
        return "cpu"
    if t.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {t.device}")
    return "cuda"


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _wrap(p):
    return p - torch.trunc(p)   # Rust .fract(), never floor


def _madd(fused: bool):
    """``c + a*b``: one rounding (the pivot chain) or two (the fm chain)."""
    return fma if fused else (lambda a, b, c: c + a * b)


def _step(p, dt, inv_sr: float):
    """One phase step, ``fma(dt, inv_sr, p)`` wrapped by ``.fract()``
    (``inv_sr == 1``: ``p + dt``, the same number)."""
    return _wrap(p + dt if inv_sr == 1.0 else fma(dt, inv_sr, p))


# ------------------------------------------------------------------ #
# K12 fract_phase3
# ------------------------------------------------------------------ #
def fract_phase3(phases, dt, B: int, inv_sr: float = 1.0):
    """Sequential fract-wrapped phases of the three chain operators.

    Args: ``phases``/``dt`` ``[3, V]`` (op3, op2, op1); ``B`` block length;
    ``inv_sr``: each step is ``fma(dt, inv_sr, p)``.  Returns (``ph3``,
    ``ph2``, ``ph1`` each ``[B, V]``, the phases before each increment, and
    the carry ``[3, V]``).  On the card a lane whose phase and increment
    ``dt*inv_sr`` (rounded) both lie in ``[+0, 1)`` steps by the short exact
    wrap ``q - (q >= 1)`` (``csrc/fm.cu``), every other lane by
    ``q - trunc(q)``; both equal the plain version bit for bit.
    """
    if phases.dim() != 2 or phases.shape[0] != 3 \
            or tuple(dt.shape) != tuple(phases.shape):
        raise ValueError(f"fract_phase3 takes phases and dt [3, V] (got "
                         f"{tuple(phases.shape)} and {tuple(dt.shape)})")
    if _device_of(phases, FRACT) == "cpu":
        return plain_fract_phase3(phases, dt, B, inv_sr)
    from . import build
    build.check_operands(phases.device, phases=phases, dt=dt)
    V = phases.shape[1]
    out = torch.empty((3, B, V), dtype=torch.float32, device=phases.device)
    carry = torch.empty_like(phases)
    fn = build.entry("fm", "oscen_fract_phase3", 4, 2, 1)
    rc = fn(phases.data_ptr(), dt.data_ptr(), out.data_ptr(),
            carry.data_ptr(), V, B, inv_sr, _stream(phases))
    launches[FRACT] += 1
    build.check_launch("fm", rc, FRACT)
    return out[0], out[1], out[2], carry


def wrap_sweep(device="cuda"):
    """The kernel's short wrap over all 2^32 float32 patterns ``q`` on the
    card: (patterns where it differs from ``q - trunc(q)`` bit for bit,
    patterns its short path takes: ``[+0, 2)``, 2^30)."""
    from . import build
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"wrap_sweep runs the card's kernel: give it a "
                         f"CUDA device (got {dev})")
    return build.run_sweep("fm", "oscen_fract_wrap_sweep", dev)


def plain_fract_phase3(phases, dt, B: int, inv_sr: float = 1.0):
    """The kernel's per-sample loop in plain PyTorch, over ``[3, V]``."""
    out = torch.empty((3, B) + tuple(phases.shape[1:]), dtype=phases.dtype,
                      device=phases.device)
    p = phases
    for t in range(B):
        out[:, t] = p
        p = _step(p, dt, inv_sr)
    return out[0], out[1], out[2], p


# ------------------------------------------------------------------ #
# K13 / K15: the fused operator chains
# ------------------------------------------------------------------ #
def _check_chain(name, phases, prevs, dt, lvl, fb, mix, env3, env2, env1):
    if env3.dim() != 2:
        raise ValueError(f"{name}: env3 must be [B, V] (got "
                         f"{tuple(env3.shape)})")
    B, V = env3.shape
    for nm, x in (("phases", phases), ("prevs", prevs), ("lvl", lvl),
                  ("fb", fb)):
        if tuple(x.shape) != (3, V):
            raise ValueError(f"{name}: {nm} must be [3, {V}] (got "
                             f"{tuple(x.shape)})")
    if tuple(dt.shape) not in ((3, B, V), (3, 1, V)):
        raise ValueError(f"{name}: dt must be [3, {B}, {V}] or [3, 1, {V}] "
                         f"(got {tuple(dt.shape)})")
    if tuple(mix.shape) != (V,):
        raise ValueError(f"{name}: mix must be [{V}] (got "
                         f"{tuple(mix.shape)})")
    for nm, x in (("env2", env2), ("env1", env1)):
        if tuple(x.shape) != (B, V):
            raise ValueError(f"{name}: {nm} must be [{B}, {V}] (got "
                             f"{tuple(x.shape)})")
    return B, V


def fast_branch_eligible(dt, B: int, pivot: bool = False) -> bool:
    """The JAX package's rule: block-constant dt and ``B % 8 == 0``; never
    the pivot's chain on the card (the module's docstring)."""
    return dt.shape[1] == 1 and B % 8 == 0 and (
        not pivot or dt.device.type == "cpu")


def _fold_levels(lvl, env3, env2, env1):
    """Each operator's level folded into its envelope stream."""
    return tuple((e * lvl[r]).contiguous()
                 for r, e in enumerate((env3, env2, env1)))


def _chain3(pivot, phases, prevs, dt, lvl, fb, mix, env3, env2, env1,
            fb_zero, inv_sr):
    name = PIVOT_CHAIN if pivot else FM_CHAIN
    B, V = _check_chain(name, phases, prevs, dt, lvl, fb, mix, env3, env2,
                        env1)
    e3, e2, e1 = _fold_levels(lvl, env3, env2, env1)
    if fb_zero and fast_branch_eligible(dt, B, pivot):
        return _chain3_fast(pivot, phases, dt[:, 0, :].contiguous(), mix,
                            e3, e2, e1, inv_sr)
    if _device_of(env3, name) == "cpu":
        return _plain_chain3(pivot, phases, prevs, dt, fb, mix, e3, e2, e1,
                             inv_sr)
    from . import build
    build.check_operands(env3.device, phases=phases, prevs=prevs, dt=dt,
                         fb=fb, mix=mix, env3=e3, env2=e2, env1=e1)
    y = torch.empty_like(e3)
    ph = torch.empty_like(phases)
    pv = torch.empty_like(prevs)
    fn = build.entry("fm", f"oscen_{name}", 11, 3, 1)
    rc = fn(phases.data_ptr(), prevs.data_ptr(), dt.data_ptr(),
            fb.data_ptr(), mix.data_ptr(), e3.data_ptr(), e2.data_ptr(),
            e1.data_ptr(), y.data_ptr(), ph.data_ptr(), pv.data_ptr(), V, B,
            V if dt.shape[1] == B and B > 1 else 0, inv_sr, _stream(env3))
    launches[name] += 1
    build.check_launch("fm", rc, name)
    return y, ph, pv


def zero_feedback_branch(pivot, phases, dt, lvl, mix, env3, env2, env1,
                         inv_sr: float = 1.0):
    """The zero-feedback branch on any device, for holding it against the
    chain kernels on the card (args as :func:`fm_chain3_scan` without the
    carried sines and feedbacks; ``dt`` ``[3, 1, V]``)."""
    return _chain3_fast(pivot, phases, dt[:, 0, :].contiguous(), mix,
                        *_fold_levels(lvl, env3, env2, env1), inv_sr)


def _chain3_fast(pivot, phases, dt_rows, mix, e3, e2, e1, inv_sr):
    """Zero-feedback branch: with every feedback 0 the only cross-sample
    dependency is the phase recurrence (:func:`fract_phase3`); the sines
    and the routing vectorize over the block, in the sequential chain's
    expressions and order."""
    B = e3.shape[0]
    ph3, ph2, ph1, phc = fract_phase3(phases, dt_rows, B, inv_sr)
    madd, sine = _madd(pivot), sin_turns_fma if pivot else sin_turns
    s3 = sine(ph3)
    a3 = s3 * e3
    s2 = sine(madd(a3, 1.0 - mix, ph2))
    a2 = s2 * e2
    s1 = sine(ph1 + madd(a3, mix, a2))
    y = s1 * e1
    if pivot:
        pv = torch.stack([s3[-1], s2[-1], s1[-1]])
    else:
        pv = torch.stack([a3[-1], a2[-1], y[-1]])
    return y, phc, pv


def _plain_chain3(pivot, phases, prevs, dt, fb, mix, e3, e2, e1,
                  inv_sr=1.0):
    """The chain kernel's per-sample loop in plain PyTorch, over ``[V]``
    rows (envelope streams already level-folded)."""
    B = e3.shape[0]
    y = torch.empty_like(e3)
    ph = phases
    p3, p2, p1 = prevs
    fb3, fb2, fb1 = fb
    om = 1.0 - mix
    madd, sine = _madd(pivot), sin_turns_fma if pivot else sin_turns
    per_sample = dt.shape[1] == B and B > 1
    for t in range(B):
        # the three phases step together: each depends on its own only
        ph3, ph2, ph1 = ph
        s3 = sine(madd(p3, fb3, ph3))
        a3 = s3 * e3[t]
        s2 = sine(madd(p2, fb2, madd(a3, om, ph2)))
        a2 = s2 * e2[t]
        s1 = sine(madd(p1, fb1, ph1 + madd(a3, mix, a2)))
        y[t] = s1 * e1[t]
        ph = _step(ph, dt[:, t] if per_sample else dt[:, 0], inv_sr)
        p3, p2, p1 = (s3, s2, s1) if pivot else (a3, a2, y[t])
    return y, ph, torch.stack([p3, p2, p1])


def fm_chain3_scan(phases, prevs, dt, lvl, fb, mix, env3, env2, env1,
                   fb_zero: bool = False, inv_sr: float = 1.0):
    """One block of the fused 3-operator FM voice chain, all voices.

    Args: ``phases``/``prevs`` ``[3, V]`` (op3, op2, op1); ``dt``
    ``[3, B, V]`` per-sample or ``[3, 1, V]`` block-constant phase
    increments, each step ``fma(dt, inv_sr, phase)``; ``lvl``/``fb``
    ``[3, V]``; ``mix`` ``[V]`` (the route, clamped); ``env3/2/1``
    ``[B, V]``; ``fb_zero``: every feedback is 0 (known on the host).
    Returns (``y`` ``[B, V]``, ``phases'``, ``prevs'``).
    """
    return _chain3(False, phases, prevs, dt, lvl, fb, mix, env3, env2, env1,
                   fb_zero, inv_sr)


def plain_fm_chain3_scan(phases, prevs, dt, lvl, fb, mix, env3, env2, env1,
                         inv_sr: float = 1.0):
    """The sequential chain in plain PyTorch (what the kernel computes)."""
    return _plain_chain3(False, phases, prevs, dt, fb, mix,
                         *_fold_levels(lvl, env3, env2, env1), inv_sr)


def pivot_chain3_scan(phases, prevs, dt, lvl, fb, mix, env3, env2, env1,
                      fb_zero: bool = False, inv_sr: float = 1.0):
    """One block of the fused pivot operator chain, all voices.

    Args as :func:`fm_chain3_scan`; ``prevs`` carries the raw sines; the
    chain's products into sums are fused multiply-adds (the module's
    docstring).  Returns (``y`` ``[B, V]``, op1's enveloped output before
    the filter; ``phases'``; ``prevs'``).
    """
    return _chain3(True, phases, prevs, dt, lvl, fb, mix, env3, env2, env1,
                   fb_zero, inv_sr)


def plain_pivot_chain3_scan(phases, prevs, dt, lvl, fb, mix, env3, env2,
                            env1, inv_sr: float = 1.0):
    """The sequential pivot chain in plain PyTorch."""
    return _plain_chain3(True, phases, prevs, dt, fb, mix,
                         *_fold_levels(lvl, env3, env2, env1), inv_sr)


# ------------------------------------------------------------------ #
# K14 fm_operator_scan
# ------------------------------------------------------------------ #
def fm_operator_scan(phase0, prev0, dt, pm, fb, env, lvl):
    """One block of the FM operator for all voices.

    Args: ``phase0``/``prev0`` ``[V]``; ``dt``/``pm``/``fb``/``env``/``lvl``
    ``[B, V]`` per-sample.  Returns (``y`` ``[B, V]``, ``phase'``,
    ``prev'``).
    """
    if dt.dim() != 2:
        raise ValueError(f"{OPERATOR}: dt must be [B, V] (got "
                         f"{tuple(dt.shape)})")
    B, V = dt.shape
    for nm, x in (("pm", pm), ("fb", fb), ("env", env), ("lvl", lvl)):
        if tuple(x.shape) != (B, V):
            raise ValueError(f"{OPERATOR}: {nm} must be [{B}, {V}] (got "
                             f"{tuple(x.shape)})")
    for nm, x in (("phase0", phase0), ("prev0", prev0)):
        if tuple(x.shape) != (V,):
            raise ValueError(f"{OPERATOR}: {nm} must be [{V}] (got "
                             f"{tuple(x.shape)})")
    if _device_of(dt, OPERATOR) == "cpu":
        return plain_fm_operator_scan(phase0, prev0, dt, pm, fb, env, lvl)
    from . import build
    build.check_operands(dt.device, phase0=phase0, prev0=prev0, dt=dt,
                         pm=pm, fb=fb, env=env, lvl=lvl)
    y = torch.empty_like(dt)
    ph = torch.empty_like(phase0)
    pv = torch.empty_like(prev0)
    fn = build.entry("fm", "oscen_fm_operator_scan", 10, 2)
    rc = fn(phase0.data_ptr(), prev0.data_ptr(), dt.data_ptr(),
            pm.data_ptr(), fb.data_ptr(), env.data_ptr(), lvl.data_ptr(),
            y.data_ptr(), ph.data_ptr(), pv.data_ptr(), V, B, _stream(dt))
    launches[OPERATOR] += 1
    build.check_launch("fm", rc, OPERATOR)
    return y, ph, pv


def plain_fm_operator_scan(phase0, prev0, dt, pm, fb, env, lvl):
    """The kernel's per-sample loop in plain PyTorch, over ``[V]`` rows:
    ``y = sin_turns(phase + (pm + prev*fb)) * env * lvl``."""
    y = torch.empty_like(dt)
    ph, prev = phase0, prev0
    for t in range(dt.shape[0]):
        out = sin_turns(ph + (pm[t] + prev * fb[t])) * env[t] * lvl[t]
        ph = _wrap(ph + dt[t])
        prev = out
        y[t] = out
    return y, ph, prev
