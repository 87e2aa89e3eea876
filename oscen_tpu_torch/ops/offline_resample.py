"""Offline band-limited resampling for conforming loaded assets.

Copy of ``oscen_tpu/ops/offline_resample.py`` (numpy on the host; it asks
the native library first, as the JAX package does, so both packages take
the same path on one machine and agree bit for bit).  Counterpart of the
reference's one-shot windowed-sinc resampler (asset/resample.rs): 32
zero-crossings per side, Blackman window, destination-Nyquist cutoff on
downsample, per-output weight normalization for exact DC gain.  Runs on
the host (NumPy) inside the asset load path — the control-thread side of
the host↔device split — vectorized over output samples instead of the
reference's per-tap loop.
"""

from __future__ import annotations

import numpy as np

ZERO_CROSSINGS = 32


def _sinc(x: np.ndarray) -> np.ndarray:
    # normalized sinc with the removable singularity filled in
    out = np.ones_like(x)
    nz = x != 0.0
    px = np.pi * x[nz]
    out[nz] = np.sin(px) / px
    return out


def _blackman(t: np.ndarray) -> np.ndarray:
    """Blackman window over t ∈ [-1, 1], zero outside (reference
    resample.rs:29-40, double-angle form)."""
    out = np.zeros_like(t)
    m = np.abs(t) <= 1.0
    phase = np.pi * (t[m] + 1.0)
    c = np.cos(phase)
    out[m] = 0.42 - 0.5 * c + 0.08 * (2.0 * c * c - 1.0)
    return out


def resample_channel(x: np.ndarray, src_rate: int,
                     dst_rate: int) -> np.ndarray:
    """Arbitrary-ratio windowed-sinc resample of one channel.

    DC maps to DC at unity gain; downsampling band-limits to the
    destination Nyquist.  Dispatches to the native C++ kernel
    (csrc/host/oscen_host.cpp) when available; the vectorized NumPy path
    below is the fallback and the parity reference.
    """
    assert src_rate > 0 and dst_rate > 0
    x = np.asarray(x, np.float32)
    if x.size == 0 or src_rate == dst_rate:
        return x.copy()

    from ..utils.native import resample_channel_native
    native = resample_channel_native(x, int(src_rate), int(dst_rate))
    if native is not None:
        return native

    ratio = dst_rate / src_rate
    out_len = int(round(len(x) * ratio))
    if out_len == 0:
        return np.zeros((0,), np.float32)

    cutoff = np.float32(min(ratio, 1.0))
    radius = ZERO_CROSSINGS / cutoff
    half = int(np.ceil(radius))

    # source center position per output sample
    pos = np.arange(out_len, dtype=np.float64) / ratio
    base = np.floor(pos).astype(np.int64)
    # window of taps around each center: offsets -half..half+1
    offs = np.arange(-half, half + 2, dtype=np.int64)
    idx = base[:, None] + offs[None, :]              # [out, taps]
    valid = (idx >= 0) & (idx < len(x))
    dist = (pos[:, None] - idx).astype(np.float32)   # in input samples
    inside = np.abs(dist) <= radius
    w = _sinc(cutoff * dist) * _blackman(dist / radius)
    w = np.where(valid & inside, w, 0.0).astype(np.float32)
    samples = x[np.clip(idx, 0, len(x) - 1)]
    acc = (w * samples).sum(axis=1)
    wsum = w.sum(axis=1)
    out = np.where(wsum != 0.0, acc / np.where(wsum == 0.0, 1.0, wsum),
                   0.0)
    return out.astype(np.float32)
