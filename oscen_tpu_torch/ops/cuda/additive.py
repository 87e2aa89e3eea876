"""Fused electric-piano additive voice: CUDA kernels and plain versions.

Counterpart of ``oscen_tpu/ops/pallas/additive.py``.  One steady block
(no gate events, block-constant frequency) of AmplitudeSource ->
OscillatorBank for every voice at once, optionally with the voice mix-down
(``with_mix``).  Two versions of the function exist, as in the reference:

- ``v4`` (default): closed form over subgroups of ``SUB = min(U, 64)``
  ticks with ``U = pick_unroll(B, 128)``.  Within a subgroup sample j
  rotates from the subgroup-entry oscillator by ``m^(j+1)`` and the
  envelope telescopes to ``amp = tgt + r1*D + r2*G1`` around the at most
  one cycle wrap, at the closed-form wrap tick ``jw = (65 - s0) mod 65``.
- ``parity``: the reference's exact per-sample op order (envelope tick,
  then rotation), ``OSCEN_ADDITIVE_KERNEL=parity``.

Selection: a CPU tensor runs the plain PyTorch version of the chosen
function, a CUDA tensor runs the kernel of ``csrc/additive.cu`` (built at
first use) or raises.  ``launches`` counts the kernel launches per version;
the plain versions are not counted.

Layout: state planes ``[H, V]`` (H = 32 harmonics, V voices), ``step``
``[V]``.  Returns ``(y, osc_re, osc_im, cur, tgt, step)`` with ``y``
``[B, V]``, or ``[B]`` with ``with_mix``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict

import torch

from .util import pick_unroll

INTERP = 64.0
NUM_HARMONICS = 32
_UNROLL = 8  # block lengths must be multiples of this
WARPS_PER_BLOCK = 2  # voices per CUDA block: 128 blocks at 256 voices

KERNELS = ("v4", "parity")
launches: Dict[str, int] = {v: 0 for v in KERNELS}

_ENTRY = {"v4": "oscen_additive_v4", "parity": "oscen_additive_parity"}
_entries: Dict[str, ctypes._CFuncPtr] = {}


def kernel_version() -> str:
    """``OSCEN_ADDITIVE_KERNEL``, default ``v4`` (read at call time)."""
    return os.environ.get("OSCEN_ADDITIVE_KERNEL", "v4")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def subgroup_len(block_len: int, version: str) -> int:
    """Subgroup length (v4) or samples per harmonic sum (parity)."""
    U = pick_unroll(block_len, max_u=64 if version == "parity" else 128)
    return min(U, 64) if version == "v4" else min(U, 32)


def additive_voice_block(osc_re, osc_im, mul_re, mul_im, cur, tgt, mult,
                         step, block_len: int, with_mix: bool = False,
                         version=None):
    """One steady block of the fused additive voice (see module doc)."""
    if version is None:
        version = kernel_version()
    if version in ("v2", "v3"):
        raise NotImplementedError(
            f"additive kernel {version!r} is not ported yet (ROADMAP.md "
            f"queue 2, K3/K4); use 'v4' or 'parity'")
    if version not in KERNELS:
        raise ValueError(f"unknown additive kernel version {version!r}")
    if block_len % _UNROLL:
        raise ValueError(
            f"block_len must be a multiple of {_UNROLL} for the fused "
            f"kernel (got {block_len})")
    sub = subgroup_len(block_len, version)
    planes = (osc_re, osc_im, mul_re, mul_im, cur, tgt, mult)
    if osc_re.device.type == "cpu":
        if version == "parity":
            return plain_parity(*planes, step, block_len, with_mix)
        return plain_v4(*planes, step, block_len, sub, with_mix)
    if osc_re.device.type != "cuda":
        raise ValueError(f"no additive kernel for device {osc_re.device}")
    return _launch(version, planes, step, block_len, sub, with_mix)


def _entry(name):
    """A kernel's C entry point, typed for ctypes (built at first use)."""
    fn = _entries.get(name)
    if fn is None:
        from .build import load_library
        lib = load_library("additive")
        if name == "error_string":
            fn = lib.oscen_cuda_error_string
            fn.restype = ctypes.c_char_p
            fn.argtypes = [ctypes.c_int]
        else:
            fn = getattr(lib, _ENTRY[name])
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
        _entries[name] = fn
    return fn


def _launch(version, planes, step, block_len, sub, with_mix):
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
    fn = _entry(version)
    n_blk = -(-V // WARPS_PER_BLOCK)
    y = torch.empty((n_blk, block_len) if with_mix else (block_len, V),
                    dtype=torch.float32, device=dev)
    outs = [torch.empty((H, V), dtype=torch.float32, device=dev)
            for _ in range(4)]
    step_o = torch.empty((V,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(*[t.data_ptr() for t in planes], step.data_ptr(), y.data_ptr(),
            *[t.data_ptr() for t in outs], step_o.data_ptr(),
            V, block_len, sub, int(with_mix), WARPS_PER_BLOCK, stream)
    launches[version] += 1
    if rc != 0:
        msg = _entry("error_string")(rc).decode()
        raise RuntimeError(f"additive {version} kernel launch failed: "
                           f"{msg} ({rc})")
    if with_mix:
        y = y.sum(dim=0)  # per-block partial mixes
    return (y, *outs, step_o)


# --------------------------------------------------------------------- #
# plain versions (CPU path; the reference the kernels are held to)
# --------------------------------------------------------------------- #
def plain_v4(osc_re, osc_im, mul_re, mul_im, cur, tgt, mult, step,
             block_len: int, sub: int, with_mix: bool = False):
    """``_kernel_v4`` in plain PyTorch: the per-voice rows run as a short
    loop over the subgroup's ticks, the plane math for all ticks at once.
    Every elementwise expression is the kernel's, in its order."""
    mr, mi = mul_re, mul_im
    dev = osc_re.device
    # m^(j+1), j = 0..sub-1, by the kernel's running-product recurrence
    mjr, mji = [mr], [mi]
    for _ in range(sub - 1):
        pr, pi = mjr[-1], mji[-1]
        mjr.append(pr * mr - pi * mi)
        mji.append(pr * mi + pi * mr)
    msr, msi = mjr[-1], mji[-1]
    mjr3 = torch.stack(mjr) * 3.0   # [SUB, H, V]
    mji3 = torch.stack(mji) * 3.0
    j_idx = torch.arange(sub, dtype=torch.float32, device=dev)[:, None]
    cj = (63.0 - j_idx) * (1.0 / 64.0)   # exact multiples of 1/64
    C = 63.0 / 64.0

    s = step.to(torch.float32)
    zr, zi = osc_re, osc_im
    tgt = torch.where(s == 0.0, cur, tgt)
    D = cur - tgt
    p = torch.ones_like(s)
    cur_last = cur
    ys = []
    for _ in range(block_len // sub):
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
        im = zr * mji3 + zi * mjr3
        rows = (im * amp).sum(dim=1)                    # [SUB, V]
        ys.append(rows.sum(dim=1) if with_mix else rows)
        cur_last = amp[-1]
        zr, zi = zr * msr - zi * msi, zr * msi + zi * msr
        w_last = jw <= float(sub - 1)
        tgt = torch.where(w_last, tgtm, tgt)
        D = torch.where(w_last, -G1, D)
        t = s + float(sub)
        s = torch.where(t >= 65.0, t - 65.0, t)
    return torch.cat(ys), zr, zi, cur_last, tgt, s


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
