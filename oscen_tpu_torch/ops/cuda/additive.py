"""Fused electric-piano additive voice: CUDA kernels and plain versions.

Counterpart of ``oscen_tpu/ops/pallas/additive.py``.  One steady block
(no gate events, block-constant frequency) of AmplitudeSource ->
OscillatorBank for every voice at once, optionally with the voice mix-down
(``with_mix``) and a stream epilogue after it.  The versions of the
function, as in the reference:

- ``v4`` (default): closed form over subgroups of ``SUB = min(U, 64)``
  ticks with ``U = pick_unroll(B, 128)``.  Within a subgroup sample j
  rotates from the subgroup-entry oscillator by ``m^(j+1)`` and the
  envelope telescopes to ``amp = tgt + r1*D + r2*G1`` around the at most
  one cycle wrap, at the closed-form wrap tick ``jw = (65 - s0) mod 65``.
- ``v3``: the same subgroups with the rows ``r1``, ``r2`` from the per-tick
  P recurrence and wrapped flag; bit-identical to ``v4``.
- ``v2``: per-tick selects of the cycle's ``(tgt, D)`` against the next
  cycle's, ``amp = tgtE + DE * P``.
- ``parity``: the reference's exact per-sample op order (envelope tick,
  then rotation), ``SUB`` = samples per harmonic sum ``min(U, 32)`` with
  ``U = pick_unroll(B, 64)``.

On the card every version splits each voice's block into
:func:`segments` time segments, one warp each, which replay the state at
their first tick; the outputs are those of one warp per voice.

``OSCEN_ADDITIVE_KERNEL`` picks the version at call time.  The epilogue
(``epi_fn``, the Tremolo pan :func:`tremolo_pan`) always runs the ``v4``
body, as in the reference; the graph never asks for it with ``parity``
(:func:`epilogue_supported`).

Selection: a CPU tensor runs the plain PyTorch version of the chosen
function, a CUDA tensor runs the kernel of ``csrc/additive.cu`` (built at
first use) or raises.  ``launches`` counts the kernel launches per version,
the epilogue's under ``v4_epilogue``; the plain versions are not counted.

Layout: state planes ``[H, V]`` (H = 32 harmonics, V voices), ``step``
``[V]``.  Returns ``(y, osc_re, osc_im, cur, tgt, step)`` with ``y``
``[B, V]``, ``[B]`` with ``with_mix``, or ``[B, epi_c]`` with an epilogue.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import torch

from .. import fmath
from .util import pick_unroll

INTERP = 64.0
NUM_HARMONICS = 32
_UNROLL = 8  # block lengths must be multiples of this
WARPS_PER_BLOCK = 2  # voices per CUDA block: 128 blocks at 256 voices
MIX_GROUP = 16  # blocks per first-level group of the in-kernel mix
# the reference's default voice tile (OSCEN_ADDITIVE_TILE, not ported): the
# epilogue needs the padded voice count inside one tile
EPILOGUE_TILE = 256
# Tremolo's anchored phase rebases at this tick count
K_REBASE = 1 << 20
TAU = 2.0 * math.pi

KERNELS = ("v4", "parity", "v3", "v2")
EPILOGUE = "v4_epilogue"
launches: Dict[str, int] = {k: 0 for k in KERNELS + (EPILOGUE,)}

_ENTRY = {v: f"oscen_additive_{v}" for v in KERNELS}
# per device: the mix's ticket counters (zero between launches)
_counters: Dict[torch.device, torch.Tensor] = {}
# counters replaced by larger ones: a captured block may still launch with
# them (graph/capture.py), so they stay allocated
_retired: List[torch.Tensor] = []


def kernel_version() -> str:
    """``OSCEN_ADDITIVE_KERNEL``, default ``v4`` (read at call time)."""
    return os.environ.get("OSCEN_ADDITIVE_KERNEL", "v4")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def subgroup_len(block_len: int, version: str) -> int:
    """Subgroup length (v4, v3, v2) or samples per harmonic sum (parity),
    as the reference picks them (``_additive_voice_block``)."""
    if version == "parity":
        return min(pick_unroll(block_len, max_u=64), 32)
    return min(pick_unroll(block_len, max_u=128), 64)


def segments(num_voices: int, block_len: int, sub: int) -> int:
    """Time segments per voice a kernel runs on the card with ``sub =
    subgroup_len(block_len, version)``, as the built library picks them
    (``csrc/additive.cu``'s ``segments()``: 4, halved until it divides the
    ``block_len / sub`` subgroups, or parity's harmonic-sum chunks, and the
    mix's ticket fields hold the voice groups).  Each segment is one warp
    that replays the state at its first tick; the outputs are those of one
    warp per voice."""
    import ctypes

    from . import build
    fn = build.load_library("additive").oscen_additive_segments
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4
    return fn(num_voices, block_len, sub, WARPS_PER_BLOCK)


def block_segments(osc_re, osc_im, mul_re, mul_im, cur, tgt, mult, step,
                   block_len: int, segs: int, with_mix: bool = False,
                   version: str = "v4"):
    """One block of kernel ``version`` (v4, v3, v2 or parity, no epilogue)
    on the card with ``segs`` time segments per voice (1, 2 or 4, dividing
    the subgroups or parity's chunks) instead of :func:`segments`' choice:
    the probes price the segment count, the card tests hold every count to
    the plain version and to one warp per voice (``segs=1``).  Not counted
    in ``launches``."""
    planes = (osc_re, osc_im, mul_re, mul_im, cur, tgt, mult)
    if osc_re.device.type != "cuda" or version not in KERNELS:
        raise ValueError("block_segments runs a kernel (v4, v3, v2, parity) "
                         "on the card")
    return _launch(version, planes, step, block_len,
                   subgroup_len(block_len, version), with_mix, None,
                   segs=segs)


def epilogue_supported(num_voices: int) -> bool:
    """True where the reference fuses a stream epilogue: the padded voice
    count fits one 256-voice tile, and not with the parity version (its
    float story stays the per-sample op order)."""
    if kernel_version() == "parity":
        return False
    return num_voices + (-num_voices % 128) <= EPILOGUE_TILE


def tremolo_pan(mix, t0, p):
    """Tremolo's per-sample pan of the mix at ticks ``t0 ..`` (the plain
    version of the kernel's epilogue; ``Tremolo._epilogue_fn``).  ``p`` is
    ``[anchor, k0, dt, depth, a2]``; returns the two channel columns."""
    n = mix.shape[0]
    ks = p[1] + (torch.arange(n, dtype=torch.float32, device=mix.device)
                 + float(t0))
    K = float(K_REBASE)
    ph = torch.where(ks < K, p[0] + p[2] * ks, p[4] + p[2] * (ks - K))
    ph = ph - torch.floor(ph)
    pan = 0.5 + fmath.sin(ph * TAU) * fmath.div(p[3], 3.0)
    return mix * pan, mix * (1.0 - pan)


def additive_voice_block(osc_re, osc_im, mul_re, mul_im, cur, tgt, mult,
                         step, block_len: int, with_mix: bool = False,
                         version=None, epi_fn=None, epi_c: int = 0,
                         epi_params=None):
    """One steady block of the fused additive voice (see module doc).

    ``epi_fn`` / ``epi_c`` / ``epi_params``: a stream epilogue after the
    mix (needs ``with_mix`` and one voice tile); the kernel implements
    :func:`tremolo_pan` with ``epi_params = [anchor, k0, dt, depth, a2]``."""
    if version is None:
        version = kernel_version()
    if version not in KERNELS:
        raise ValueError(f"unknown additive kernel version {version!r}")
    if block_len % _UNROLL:
        raise ValueError(
            f"block_len must be a multiple of {_UNROLL} for the fused "
            f"kernel (got {block_len})")
    H, V = osc_re.shape
    if epi_fn is not None:
        if not with_mix or V + (-V % 128) > EPILOGUE_TILE:
            raise ValueError("epilogue fusion requires with_mix and one "
                             "voice tile (see epilogue_supported)")
        version = "v4"   # the reference's epilogue runs the v4 body
    planes = (osc_re, osc_im, mul_re, mul_im, cur, tgt, mult)
    if osc_re.device.type == "cpu":
        out = plain_block(*planes, step, block_len, with_mix, version)
        if epi_fn is None:
            return out
        cols = epi_fn(out[0], 0, epi_params)
        return (torch.stack(cols, dim=-1), *out[1:])
    if osc_re.device.type != "cuda":
        raise ValueError(f"no additive kernel for device {osc_re.device}")
    if epi_fn is not None and (epi_fn is not tremolo_pan or epi_c != 2):
        raise ValueError("the epilogue kernel implements tremolo_pan "
                         "(2 channels) only")
    return _launch(version, planes, step, block_len,
                   subgroup_len(block_len, version), with_mix,
                   epi_params if epi_fn is not None else None)


def _mix_counters(dev, n: int) -> torch.Tensor:
    """At least ``n`` zeroed ticket counters on ``dev``, shared by every
    launch with the mix: each leaves them zeroed for the next, so launches
    that take them must be ordered (one stream, as the block function
    runs)."""
    c = _counters.get(dev)
    if c is None or c.numel() < n:
        if c is not None:
            _retired.append(c)
        c = torch.zeros((n,), dtype=torch.int32, device=dev)
        _counters[dev] = c
    return c


def _launch(version, planes, step, block_len, sub, with_mix, epi,
            segs=None):
    from . import build
    H, V = planes[0].shape
    dev = planes[0].device
    if H != NUM_HARMONICS:
        raise ValueError(f"the kernel takes {NUM_HARMONICS} harmonics "
                         f"(got {H})")
    for t in planes:
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != (H, V) or not t.is_contiguous():
            raise ValueError(
                f"additive planes must be contiguous float32 [{H}, {V}] "
                f"on {dev} (got {t.dtype} {tuple(t.shape)} on {t.device})")
    if step.device != dev or tuple(step.shape) != (V,):
        raise ValueError(f"step must be [{V}] on {dev}")
    step = step.to(torch.float32).contiguous()
    if epi is not None:
        epi = epi.to(torch.float32).contiguous()
        if epi.device != dev or tuple(epi.shape) != (5,):
            raise ValueError(f"epi_params must be [5] on {dev}")
    if segs is None:
        fn = build.entry("additive", _ENTRY[version], 17, 5)
    else:   # an explicit segment count; parity's body is version 0
        entry = build.entry("additive", "oscen_additive_closed_segs", 17, 7)
        ver = 0 if version == "parity" else int(version[1])

        def fn(*a):
            return entry(*a[:-1], ver, segs, a[-1])
    n_blk = -(-V // WARPS_PER_BLOCK)
    part = cnt = None
    if with_mix:
        n_grp = -(-n_blk // MIX_GROUP)
        # the blocks' rows, the groups' rows, the epilogue's pan factors
        part = torch.empty((n_blk + n_grp + 1, block_len),
                           dtype=torch.float32, device=dev)
        cnt = _mix_counters(dev, 1 + n_grp)
        y = torch.empty((block_len, 2) if epi is not None else (block_len,),
                        dtype=torch.float32, device=dev)
    else:
        y = torch.empty((block_len, V), dtype=torch.float32, device=dev)
    outs = [torch.empty((H, V), dtype=torch.float32, device=dev)
            for _ in range(4)]
    step_o = torch.empty((V,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = fn(*[t.data_ptr() for t in planes], step.data_ptr(), y.data_ptr(),
            ptr(part), ptr(cnt), ptr(epi), *[t.data_ptr() for t in outs],
            step_o.data_ptr(), V, block_len, sub, int(with_mix),
            WARPS_PER_BLOCK, stream)
    if segs is None:
        launches[EPILOGUE if epi is not None else version] += 1
    build.check_launch("additive", rc, f"additive {version}")
    return (y, *outs, step_o)


# --------------------------------------------------------------------- #
# plain versions (CPU path; the reference the kernels are held to)
# --------------------------------------------------------------------- #
def _rows_v4(tgt, D, p, s, mult, sub, j_idx):
    """v4's envelope over one subgroup: the wrap tick in closed form."""
    C = 63.0 / 64.0
    cj = (63.0 - j_idx) * (1.0 / 64.0)   # exact multiples of 1/64
    tgtm = tgt * mult
    G1 = tgtm - tgt
    at0 = s == 0.0
    jw = torch.where(at0, 0.0, 65.0 - s)
    basef = s * (-1.0 / 64.0)
    addf = torch.where(at0, 0.0, 65.0 / 64.0)
    wfb = jw <= j_idx                               # [SUB, V]
    f = (basef + cj) + torch.where(wfb, addf, 0.0)
    hit = jw == j_idx
    ps = []
    for j in range(sub):
        p = torch.where(hit[j], C, p * f[j])
        ps.append(p)
    P = torch.stack(ps)
    r1 = torch.where(wfb, 0.0, P)[:, None, :]
    r2 = torch.where(wfb, 1.0 - P, 0.0)[:, None, :]
    amp = r2 * G1 + (r1 * D + tgt)                  # [SUB, H, V]
    w_last = jw <= float(sub - 1)
    t = s + float(sub)
    return (amp, torch.where(w_last, tgtm, tgt), torch.where(w_last, -G1, D),
            p, torch.where(t >= 65.0, t - 65.0, t))


def _rows_v3(tgt, D, p, s, mult, sub, j_idx):
    """v3's envelope over one subgroup: the P recurrence and the wrapped
    flag tick by tick, then v4's amp expression."""
    tgtm = tgt * mult
    G1 = tgtm - tgt
    wrapped = torch.zeros_like(s, dtype=torch.bool)
    r1s, r2s = [], []
    for _ in range(sub):
        wrap = s == 0.0
        wrapped = torch.logical_or(wrapped, wrap)
        p = torch.where(wrap, 63.0 / 64.0, p * (1.0 - (s + 1.0) / INTERP))
        r1s.append(torch.where(wrapped, 0.0, p))
        r2s.append(torch.where(wrapped, 1.0 - p, 0.0))
        s = torch.where(s < INTERP, s + 1.0, 0.0)
    r1 = torch.stack(r1s)[:, None, :]
    r2 = torch.stack(r2s)[:, None, :]
    amp = r2 * G1 + (r1 * D + tgt)
    return (amp, torch.where(wrapped, tgtm, tgt), torch.where(wrapped, -G1, D),
            p, s)


def _rows_v2(tgt, D, p, s, mult, sub, j_idx):
    """v2's envelope over one subgroup: per-tick selects of (tgt, D)
    against the next cycle's (tgt2, D2), ``amp = tgtE + DE * P``."""
    tgt2 = tgt * mult
    D2 = tgt - tgt2
    wrapped = torch.zeros_like(s, dtype=torch.bool)
    ps, ws = [], []
    for _ in range(sub):
        wrap = s == 0.0
        wrapped = torch.logical_or(wrapped, wrap)
        p = torch.where(wrap, 63.0 / 64.0, p * (1.0 - (s + 1.0) / INTERP))
        ps.append(p)
        ws.append(wrapped)
        s = torch.where(s < INTERP, s + 1.0, 0.0)
    P = torch.stack(ps)[:, None, :]
    W = torch.stack(ws)[:, None, :]
    amp = torch.where(W, tgt2, tgt) + torch.where(W, D2, D) * P
    return (amp, torch.where(wrapped, tgt2, tgt), torch.where(wrapped, D2, D),
            p, s)


def _plain_closed(rows_fn, osc_re, osc_im, mul_re, mul_im, cur, tgt, mult,
                  step, block_len: int, sub: int, with_mix: bool):
    """The closed-form kernels in plain PyTorch: the per-voice rows by
    ``rows_fn`` over each subgroup, the plane math for all its ticks at
    once.  Every elementwise expression is the kernel's, in its order."""
    mr, mi = mul_re, mul_im
    # m^(j+1), j = 0..sub-1, by the kernel's running-product recurrence
    mjr, mji = [mr], [mi]
    for _ in range(sub - 1):
        pr, pi = mjr[-1], mji[-1]
        mjr.append(pr * mr - pi * mi)
        mji.append(pr * mi + pi * mr)
    msr, msi = mjr[-1], mji[-1]
    mjr3 = torch.stack(mjr) * 3.0   # [SUB, H, V]
    mji3 = torch.stack(mji) * 3.0
    j_idx = torch.arange(sub, dtype=torch.float32,
                         device=osc_re.device)[:, None]

    s = step.to(torch.float32)
    zr, zi = osc_re, osc_im
    tgt = torch.where(s == 0.0, cur, tgt)
    D = cur - tgt
    p = torch.ones_like(s)
    cur_last = cur
    ys = []
    for _ in range(block_len // sub):
        amp, tgt, D, p, s = rows_fn(tgt, D, p, s, mult, sub, j_idx)
        im = zr * mji3 + zi * mjr3
        rows = (im * amp).sum(dim=1)                    # [SUB, V]
        ys.append(rows.sum(dim=1) if with_mix else rows)
        cur_last = amp[-1]
        zr, zi = zr * msr - zi * msi, zr * msi + zi * msr
    return torch.cat(ys), zr, zi, cur_last, tgt, s


def plain_v4(osc_re, osc_im, mul_re, mul_im, cur, tgt, mult, step,
             block_len: int, sub: int, with_mix: bool = False):
    """``_kernel_v4`` in plain PyTorch."""
    return _plain_closed(_rows_v4, osc_re, osc_im, mul_re, mul_im, cur, tgt,
                         mult, step, block_len, sub, with_mix)


def plain_v3(osc_re, osc_im, mul_re, mul_im, cur, tgt, mult, step,
             block_len: int, sub: int, with_mix: bool = False):
    """``_kernel_v3`` in plain PyTorch (equal to :func:`plain_v4`)."""
    return _plain_closed(_rows_v3, osc_re, osc_im, mul_re, mul_im, cur, tgt,
                         mult, step, block_len, sub, with_mix)


def plain_v2(osc_re, osc_im, mul_re, mul_im, cur, tgt, mult, step,
             block_len: int, sub: int, with_mix: bool = False):
    """``_kernel`` (v2) in plain PyTorch."""
    return _plain_closed(_rows_v2, osc_re, osc_im, mul_re, mul_im, cur, tgt,
                         mult, step, block_len, sub, with_mix)


def plain_parity(osc_re, osc_im, mul_re, mul_im, cur, tgt, mult, step,
                 block_len: int, with_mix: bool = False):
    """``_kernel_parity`` in plain PyTorch: per sample, the envelope tick
    then the rotation, on whole ``[H, V]`` planes."""
    mr, mi = mul_re, mul_im
    zr, zi, c, tg = osc_re, osc_im, cur, tgt
    s = step.to(torch.float32)
    rows = []
    for _ in range(block_len):
        tg = torch.where(s == 0.0, c * mult, tg)
        interp = s < INTERP
        tau = (s + 1.0) / INTERP
        c_i = c * (1.0 - tau) + tg * tau
        c = torch.where(interp, c_i, tg)
        s = torch.where(interp, s + 1.0, 0.0)
        zr, zi = zr * mr - zi * mi, zr * mi + zi * mr
        rows.append((zi * c).sum(dim=0) * 3.0)
    Y = torch.stack(rows)   # [B, V]
    return (Y.sum(dim=1) if with_mix else Y), zr, zi, c, tg, s


_CLOSED = {"v4": plain_v4, "v3": plain_v3, "v2": plain_v2}


def plain_block(osc_re, osc_im, mul_re, mul_im, cur, tgt, mult, step,
                block_len: int, with_mix: bool = False, version: str = "v4"):
    """The plain version of kernel ``version`` at the subgroup length the
    kernel takes for ``block_len`` (no epilogue)."""
    planes = (osc_re, osc_im, mul_re, mul_im, cur, tgt, mult)
    if version == "parity":
        return plain_parity(*planes, step, block_len, with_mix)
    return _CLOSED[version](*planes, step, block_len,
                            subgroup_len(block_len, version), with_mix)
