"""Sequential-in-time, parallel-in-voice IIR scans: CUDA kernels and plain
versions.

Counterpart of ``oscen_tpu/ops/pallas/iir.py``; holds the TPT SVF lowpass
(the LP18, biquad and allpass-cascade scans come with their slices).  The
reference's per-sample op order is kept (filters/tpt/mod.rs:108-123), so
the output is bit-identical across block sizes.

Selection: a CPU tensor runs the plain version, a CUDA tensor runs the
kernel of ``csrc/iir.cu`` (built at first use) or raises.  ``launches``
counts the kernel's launches; the plain version is not counted.
"""

from __future__ import annotations

from typing import Dict

import torch

KERNEL = "tpt_svf_scan"
launches: Dict[str, int] = {KERNEL: 0}


def reset_launches() -> None:
    launches[KERNEL] = 0


def tpt_svf_scan(x, h, g, k, z0, z1):
    """Zavalishin TPT SVF lowpass over a block, voice-parallel.

    Args: ``x`` ``[B, V]`` time-major; ``h``/``g``/``k`` each ``[V]``
    (block-constant) or ``[B, V]`` (per-sample); ``z0``/``z1`` ``[V]``.
    Returns (``y`` ``[B, V]``, ``z0'``, ``z1'``).
    """
    if x.dim() != 2:
        raise ValueError(f"x must be [B, V] (got {tuple(x.shape)})")
    B, V = x.shape
    for nm, c in (("h", h), ("g", g), ("k", k)):
        if tuple(c.shape) not in ((V,), (B, V)):
            raise ValueError(f"{nm} must be [{V}] or [{B}, {V}] (got "
                             f"{tuple(c.shape)})")
    for nm, z in (("z0", z0), ("z1", z1)):
        if tuple(z.shape) != (V,):
            raise ValueError(f"{nm} must be [{V}] (got {tuple(z.shape)})")
    if x.device.type == "cpu":
        return plain_tpt_svf_scan(x, h, g, k, z0, z1)
    if x.device.type != "cuda":
        raise ValueError(f"no tpt_svf_scan kernel for device {x.device}")
    from . import build
    build.check_operands(x.device, x=x, h=h, g=g, k=k, z0=z0, z1=z1)
    y = torch.empty_like(x)
    z0o = torch.empty_like(z0)
    z1o = torch.empty_like(z1)
    fn = build.entry("iir", "oscen_tpt_svf_scan", 9, 5)
    rc = fn(x.data_ptr(), h.data_ptr(), g.data_ptr(), k.data_ptr(),
            z0.data_ptr(), z1.data_ptr(), y.data_ptr(), z0o.data_ptr(),
            z1o.data_ptr(), V, B,
            *[V if c.dim() == 2 else 0 for c in (h, g, k)],
            torch.cuda.current_stream(x.device).cuda_stream)
    launches[KERNEL] += 1
    build.check_launch("iir", rc, KERNEL)
    return y, z0o, z1o


def plain_tpt_svf_scan(x, h, g, k, z0, z1):
    """The kernel's per-sample loop in plain PyTorch, over ``[V]`` rows."""
    y = torch.empty_like(x)
    rows = [c.dim() == 1 for c in (h, g, k)]
    for t in range(x.shape[0]):
        ht, gt, kt = (c if row else c[t]
                      for c, row in zip((h, g, k), rows))
        high = (x[t] - z0 * kt - z1) * ht
        band = high * gt + z0
        low = band * gt + z1
        z0 = high * gt + band
        z1 = band * gt + low
        y[t] = low
    return y, z0, z1
