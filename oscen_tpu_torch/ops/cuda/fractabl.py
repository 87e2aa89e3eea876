"""Store-layout ablations of ``fract_phase3`` (K17): the CUDA kernel and
the plain versions.

Counterpart of the ablation tools ``tools/fractabl.py`` and
``tools/fractabl2.py`` of the JAX package.  Each layout computes K12's
recurrence (:func:`oscen_tpu_torch.ops.cuda.fm.fract_phase3`: ``p += dt;
p -= trunc(p)`` on a ``[3, V]`` plane, the phase before each increment
stored) and stores it differently:

- ``direct``: the whole ``[3, V]`` plane per step into one ``[B, 3, V]``
  output;
- ``packed``: the tool's ``[6, 128]`` sublane packing; its output
  ``[B * 6, 128]`` has the memory order of ``[B, 3, V]``.  On the card two
  voices per thread with ``float2`` loads and stores (``csrc/fractabl.cu``);
- ``seg``: a boundary sweep storing only the ``S = 8`` segment starts, then
  all segments replayed in parallel into a j-major ``[SEG, 3 * S, V]``
  output (:func:`seg_planes` un-permutes it, as ``fractabl2.py:144-147``).

On the card every layout steps as K12 does: a lane whose p0 and dt lie in
``[+0, 1)`` by the short exact wrap ``q - (q >= 1)``, every other lane by
``q - trunc(q)`` (``csrc/short_wrap.cuh``), so each prices its store
layout against K12's body alone.  Every layout is bit-equal to
``fract_phase3``.  :func:`consume` is
``fractabl2``'s consumer, the zero-feedback FM chain's sines, routing and
envelopes (``fractabl2.py:48-55``); it stays plain PyTorch.

Selection: a CPU tensor runs the plain version, a CUDA tensor runs
``csrc/fractabl.cu``'s ``fract_abl_kernel`` (built at first use) or raises.
``launches`` counts the kernel's launches; the plain versions are not
counted.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..fastmath import sin_turns

LAYOUTS = ("direct", "packed", "seg")
S = 8   # segments of the seg layout (tools/fractabl2.py)
KERNEL = "fract_abl"
launches: Dict[str, int] = {KERNEL: 0}


def _wrap(p):
    return p - torch.trunc(p)   # Rust .fract(), never floor


def _check(layout, phases, dt, B):
    if layout not in LAYOUTS:
        raise ValueError(f"unknown fract layout {layout!r}")
    if phases.dim() != 2 or phases.shape[0] != 3 \
            or tuple(dt.shape) != tuple(phases.shape):
        raise ValueError(f"{layout}: phases and dt must be [3, V] (got "
                         f"{tuple(phases.shape)} and {tuple(dt.shape)})")
    if layout == "seg" and B % S:
        raise ValueError(f"seg: B must be a multiple of {S} (got {B})")
    if layout == "packed" and phases.shape[1] % 2:
        raise ValueError("packed: V must be even")


def fract_layout_raw(layout: str, phases, dt, B: int):
    """One launch of ``layout``; returns (the layout's raw output, carry
    ``[3, V]``): ``[B, 3, V]`` for direct and packed, ``[B / S, 3 * S, V]``
    for seg."""
    _check(layout, phases, dt, B)
    if phases.device.type == "cpu":
        return PLAIN[layout](phases, dt, B)
    if phases.device.type != "cuda":
        raise ValueError(f"no {KERNEL} kernel for device {phases.device}")
    from . import build
    build.check_operands(phases.device, phases=phases, dt=dt)
    V = phases.shape[1]
    shape = (B // S, 3 * S, V) if layout == "seg" else (B, 3, V)
    out = torch.empty(shape, dtype=torch.float32, device=phases.device)
    carry = torch.empty_like(phases)
    fn = build.entry("fractabl", "oscen_fract_abl", 4, 3)
    rc = fn(phases.data_ptr(), dt.data_ptr(), out.data_ptr(),
            carry.data_ptr(), LAYOUTS.index(layout), V, B,
            torch.cuda.current_stream(phases.device).cuda_stream)
    launches[KERNEL] += 1
    build.check_launch("fractabl", rc, f"{KERNEL} {layout}")
    return out, carry


def planes(layout: str, out):
    """The ``[B, V]`` planes of op3, op2, op1 of a raw output (views)."""
    if layout == "seg":
        return seg_planes(out)
    return out[:, 0], out[:, 1], out[:, 2]


def seg_planes(o):
    """Un-permute the j-major ``[SEG, 3 * S, V]`` output: ``o[j, k*S + s]``
    is operator k at time ``s * SEG + j`` (``fractabl2.py:144-147``)."""
    seg, _, V = o.shape

    def plane(k):
        return o[:, k * S:(k + 1) * S, :].transpose(0, 1).reshape(seg * S, V)
    return plane(0), plane(1), plane(2)


def fract_layout(layout: str, phases, dt, B: int):
    """``fract_phase3`` through ``layout``: (``ph3``, ``ph2``, ``ph1``
    ``[B, V]``, carry ``[3, V]``)."""
    out, carry = fract_layout_raw(layout, phases, dt, B)
    return (*planes(layout, out), carry)


def plain_direct(phases, dt, B: int):
    """``_direct_kernel``: the plane stored whole at every step."""
    out = torch.empty((B,) + tuple(phases.shape), dtype=phases.dtype,
                      device=phases.device)
    p = phases
    for t in range(B):
        out[t] = p
        p = _wrap(p + dt)
    return out, p


def plain_packed(phases, dt, B: int):
    """``_packed_kernel``: the loop on the plane packed as ``[3V/128, 128]``
    (``[6, 128]`` at V = 256; two voices per row, the card's packing, when
    V is not a multiple of 128), the output seen as ``[B, 3, V]``."""
    V = phases.shape[1]
    cols = 128 if V % 128 == 0 else 2
    rows = 3 * V // cols
    pp = phases.reshape(rows, cols)
    dd = dt.reshape(rows, cols)
    out = torch.empty((B * rows, cols), dtype=phases.dtype,
                      device=phases.device)
    for t in range(B):
        out[t * rows:(t + 1) * rows] = pp
        pp = _wrap(pp + dd)
    return out.reshape(B, 3, V), pp.reshape(3, V)


def plain_seg(phases, dt, B: int):
    """``_seg_kernel``: phase A sweeps ``(S - 1) * SEG`` steps keeping the
    S boundaries, phase B replays the op-major ``[3 * S, V]`` plane (row
    ``k * S + s``: op k, segment s) for SEG steps into ``[SEG, 3S, V]``."""
    seg = B // S
    V = phases.shape[1]
    bounds = [phases]
    p = phases
    for _ in range(S - 1):
        for _ in range(seg):
            p = _wrap(p + dt)
        bounds.append(p)
    P = torch.stack(bounds, dim=1).reshape(3 * S, V)
    dtP = dt[:, None, :].expand(3, S, V).reshape(3 * S, V)
    out = torch.empty((seg, 3 * S, V), dtype=phases.dtype,
                      device=phases.device)
    for j in range(seg):
        out[j] = P
        P = _wrap(P + dtP)
    return out, P.reshape(3, S, V)[:, S - 1]


PLAIN = {"direct": plain_direct, "packed": plain_packed, "seg": plain_seg}


def consume(ph3, ph2, ph1, e3, e2, e1, mix):
    """``fractabl2``'s consumer: the zero-feedback chain's sines, routing
    and envelopes on ``[B, V]`` phases, ``mix`` ``[V]``."""
    mixr = mix[None, :]
    y3 = sin_turns(ph3) * e3
    a = y3 * (1.0 - mixr)
    b = y3 * mixr
    y2 = sin_turns(ph2 + a) * e2
    return sin_turns(ph1 + (y2 + b)) * e1
