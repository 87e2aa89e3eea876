"""Fixed-ratio resampler kernels for multirate (oversampled) regions.

Counterpart of ``oscen_tpu/ops/resample.py`` (the reference's kernel
families, resample/): Latch (zero-order hold), Linear, Sinc FIR (the 23-tap
Kaiser halfband, polyphase, cascaded 2x stages) and IIR halfband (the
two-branch first-order allpass cascade).  Same coefficients, same
latencies, same state trees as the JAX package on the CPU.

Every kernel is ``(init_state, process_block)``: ``process_block(state,
x) -> (state, y)`` maps ``[B, ...]`` to ``[B*N, ...]`` (up) or ``[B*N,
...]`` to ``[B, ...]`` (down), carrying filter histories across blocks.
All work on the leading time axis and broadcast over trailing axes.

Only the stage-interleaved sinc layout is ported: it is the JAX package's
CPU layout (its phase-major form, the TPU default, computes the same
values in the same per-sample order, ``:250-252``, ``:342-343``), so its
state tree is the one ``utils/convert.py`` carries.  The FIR taps are
shifted adds in the JAX package's order, never ``conv1d`` (a float32
convolution on the card goes through cuDNN in TF32 by default, and sums
in another order).  The IIR halfband's branches run through
``ops/cuda/iir.py::allpass_cascade_scan`` (the CUDA kernel on the card),
both branches of a stage as lanes of one launch.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import fmath
from .cuda.iir import allpass_cascade_scan

# --------------------------------------------------------------------- #
# coefficients (reference resample/coeffs.rs)
# --------------------------------------------------------------------- #
# half of the non-zero taps of the 23-tap Kaiser (beta ~ 8.6) halfband FIR;
# HALFBAND_23_HALF[k] is the tap at index 2k (k = 0..5), the center tap
# (index 11) stored separately
HALFBAND_23_HALF = np.array([
    -3.8558514e-5, 1.2218465e-3, -7.2854808e-3,
    2.6409210e-2, -7.8128843e-2, 3.0782697e-1], np.float32)
HALFBAND_23_CENTER = np.float32(0.4999897)
HALFBAND_23_GROUP_DELAY = 11  # at the high (2x) rate

# IIR halfband: two-branch allpass cascade betas (reference coeffs.rs:48-49)
BRANCH_A_BETAS = (0.1355741, 0.6975849)
BRANCH_B_BETAS = (0.4253804, 0.9055601)
IIR_HALFBAND_GROUP_DELAY = 2


def _stages(n: int) -> int:
    if n not in (1, 2, 4, 8):
        raise ValueError("oversampling factor must be 1, 2, 4 or 8")
    return n.bit_length() - 1


def _zeros_like_payload(like):
    shape = tuple(like.shape[1:]) if like is not None else ()
    return torch.zeros(shape, dtype=torch.float32)


def _causal_fir(x, hist, taps):
    """Causal FIR along axis 0 with carried history ``hist`` (``[len(taps)
    - 1, ...]``, most recent last), as shifted adds in the tap order.
    Returns (y, new_hist)."""
    t = len(taps)
    z = torch.cat([hist, x], dim=0)
    n = x.shape[0]
    y = torch.zeros_like(x)
    for k in range(t):
        y = y + float(taps[k]) * z[t - 1 - k:t - 1 - k + n]
    return y, z[-(t - 1):]


# --------------------------------------------------------------------- #
# Latch (reference resample/latch.rs): zero-order hold, latency 0
# --------------------------------------------------------------------- #
class LatchUp:
    def __init__(self, n: int):
        self.n = n

    def init_state(self, like=None):
        return ()

    def process_block(self, state, x):
        return state, torch.repeat_interleave(x, self.n, dim=0)

    def latency_samples(self) -> int:
        return 0


class LatchDown:
    def __init__(self, n: int):
        self.n = n

    def init_state(self, like=None):
        return ()

    def process_block(self, state, x):
        return state, x[::self.n]

    def latency_samples(self) -> int:
        return 0


# --------------------------------------------------------------------- #
# Linear (reference resample/linear.rs)
# --------------------------------------------------------------------- #
class LinearUp:
    """N-point linear interpolation against the previous source sample;
    latency N."""

    def __init__(self, n: int):
        self.n = n

    def init_state(self, like=None):
        return {"prev": _zeros_like_payload(like)}

    def process_block(self, state, x):
        n = self.n
        prev = torch.cat([state["prev"][None], x[:-1]], dim=0)
        # arange(n) / n as XLA compiles it (a product with the reciprocal)
        frac = fmath.div_const(
            torch.arange(n, dtype=torch.float32, device=x.device), n)
        frac = frac.reshape((1, n) + (1,) * (x.dim() - 1))
        seg = prev[:, None] + (x - prev)[:, None] * frac
        return {"prev": x[-1]}, seg.reshape((x.shape[0] * n,)
                                            + tuple(x.shape[1:]))

    def latency_samples(self) -> int:
        return self.n


class LinearDown:
    """N-tap box average; latency (N-1)/2 source samples."""

    def __init__(self, n: int):
        self.n = n

    def init_state(self, like=None):
        return ()

    def process_block(self, state, x):
        n = self.n
        grp = x.reshape((x.shape[0] // n, n) + tuple(x.shape[1:]))
        # summed left to right, so the card and the CPU agree
        total = grp[:, 0]
        for j in range(1, n):
            total = total + grp[:, j]
        return state, fmath.div_const(total, n)

    def latency_samples(self) -> int:
        return (self.n - 1) // 2


# --------------------------------------------------------------------- #
# Sinc FIR halfband (reference resample/sinc_fir.rs)
# --------------------------------------------------------------------- #
class _Halfband2xUp:
    """One polyphase 2x up stage: even branch = 12-tap FIR over the
    low-rate stream (x2 gain), odd branch = delayed center tap
    (reference sinc_fir.rs:33-82)."""

    EVEN_TAPS = np.concatenate([HALFBAND_23_HALF,
                                HALFBAND_23_HALF[::-1]]) * 2.0
    ODD_GAIN = float(2.0 * HALFBAND_23_CENTER)
    ODD_DELAY = 5

    def init_state(self, like=None):
        z = _zeros_like_payload(like)
        return {"hist": z.expand((11,) + tuple(z.shape)).clone(),
                "odd_hist": z.expand((self.ODD_DELAY,)
                                     + tuple(z.shape)).clone()}

    def process_block(self, state, x):
        even, hist = _causal_fir(x, state["hist"], self.EVEN_TAPS)
        zo = torch.cat([state["odd_hist"], x], dim=0)
        odd = zo[:x.shape[0]] * self.ODD_GAIN
        y = torch.stack([even, odd], dim=1).reshape(
            (2 * x.shape[0],) + tuple(x.shape[1:]))
        return {"hist": hist, "odd_hist": zo[-self.ODD_DELAY:]}, y


class _Halfband2xDown:
    """One 2x down stage: the 23-tap FIR at the high rate sampled at even
    indices (reference sinc_fir.rs:84-144), computed polyphase at the low
    rate: ``y[n] = sum_j h[2j] x_even[n-j] + h[11] x_odd[n-6]``, the center
    tap added between j=5 and j=6, where tap index 11 sits in the flat
    23-tap loop."""

    EVEN_TAPS = np.concatenate([HALFBAND_23_HALF, HALFBAND_23_HALF[::-1]])
    CENTER = float(HALFBAND_23_CENTER)
    ODD_DELAY = 6

    def init_state(self, like=None):
        z = _zeros_like_payload(like)
        return {"hist_e": z.expand((11,) + tuple(z.shape)).clone(),
                "hist_o": z.expand((self.ODD_DELAY,)
                                   + tuple(z.shape)).clone()}

    def process_block(self, state, x):
        b = x.shape[0] // 2
        pair = x.reshape((b, 2) + tuple(x.shape[1:]))
        e, o = pair[:, 0], pair[:, 1]
        ze = torch.cat([state["hist_e"], e], dim=0)
        zo = torch.cat([state["hist_o"], o], dim=0)
        y = torch.zeros_like(e)
        for j in range(12):
            if j == 6:  # flat tap index 11 (the center) lands here
                y = y + self.CENTER * zo[0:b]
            y = y + float(self.EVEN_TAPS[j]) * ze[11 - j:11 - j + b]
        return {"hist_e": ze[-11:], "hist_o": zo[-self.ODD_DELAY:]}, y


class SincUpFir:
    """Cascaded halfband 2x up stages for N in {1, 2, 4, 8} (reference
    sinc_fir.rs:146-206), stage-interleaved."""

    def __init__(self, n: int):
        self.n = n
        self.stages = [_Halfband2xUp() for _ in range(_stages(n))]

    def init_state(self, like=None):
        return tuple(s.init_state(like) for s in self.stages)

    def process_block(self, state, x):
        new = []
        for st, stage in zip(state, self.stages):
            st, x = stage.process_block(st, x)
            new.append(st)
        return tuple(new), x

    def latency_samples(self) -> int:
        k = len(self.stages)
        return 0 if k == 0 else HALFBAND_23_GROUP_DELAY * ((1 << k) - 1)


class SincDownFir(SincUpFir):
    """Cascaded halfband 2x down stages, stage-interleaved.  Parity with
    the reference's per-sample loop is tolerance-level only: the reference
    adds the center tap first and symmetric pairs as ``(left+right)*tap``."""

    def __init__(self, n: int):
        self.n = n
        self.stages = [_Halfband2xDown() for _ in range(_stages(n))]


# --------------------------------------------------------------------- #
# IIR halfband (reference resample/halfband_iir.rs)
# --------------------------------------------------------------------- #
class _IirHalfband2x:
    """Two-branch allpass polyphase halfband (reference :65-145).  The
    branches' first-order allpasses keep the reference's per-sample op
    order (``y = a*(x - y_prev) + x_prev``), so an oversampled region stays
    block-size invariant; an associative scan would reassociate."""

    def __init__(self):
        # per-lane betas [S, 2V] (branch A lanes, then branch B), built
        # once per lane count and device
        self._coefs: Dict[Tuple[int, str], torch.Tensor] = {}

    def init_state(self, like=None):
        z = _zeros_like_payload(like)
        return {"a_x": (z, z), "a_y": (z, z),
                "b_x": (z, z), "b_y": (z, z),
                "prev_odd": z}

    def _coef(self, V: int, device) -> torch.Tensor:
        key = (V, str(device))
        c = self._coefs.get(key)
        if c is None:
            c = torch.tensor(
                np.repeat(np.array([BRANCH_A_BETAS, BRANCH_B_BETAS],
                                   np.float32).T, V, axis=1),
                device=device)
            self._coefs[key] = c
        return c

    def _branches(self, state, xa, xb):
        """Branch A over ``xa`` and branch B over ``xb`` as the two halves
        of the lanes of one ``allpass_cascade_scan``."""
        shp = tuple(xa.shape[1:])
        b = xa.shape[0]
        V = int(np.prod(shp, dtype=np.int64))
        x = torch.cat([xa.reshape(b, V), xb.reshape(b, V)], dim=1)
        S = len(BRANCH_A_BETAS)

        def rows(key_a, key_b):
            return torch.stack([torch.cat([state[key_a][s].reshape(V),
                                           state[key_b][s].reshape(V)])
                                for s in range(S)])
        y, xp, yp = allpass_cascade_scan(x, self._coef(V, x.device),
                                         rows("a_x", "b_x"),
                                         rows("a_y", "b_y"))

        def split(h, lo):
            return tuple(h[s, lo:lo + V].reshape(shp) for s in range(S))
        new = {"a_x": split(xp, 0), "a_y": split(yp, 0),
               "b_x": split(xp, V), "b_y": split(yp, V)}
        return (y[:, :V].reshape(xa.shape), y[:, V:].reshape(xb.shape),
                new)

    def up(self, state, x):
        ya, yb, new = self._branches(state, x, x)
        y = torch.stack([ya, yb], dim=1).reshape(
            (2 * x.shape[0],) + tuple(x.shape[1:]))
        return {**state, **new}, y

    def down(self, state, x):
        even, odd = x[::2], x[1::2]
        odd_delayed = torch.cat([state["prev_odd"][None], odd[:-1]], dim=0)
        ya, yb, new = self._branches(state, even, odd_delayed)
        return {**new, "prev_odd": odd[-1]}, (ya + yb) * 0.5


class IirHalfbandUp:
    def __init__(self, n: int):
        self.n = n
        self.stages = [_IirHalfband2x() for _ in range(_stages(n))]

    def init_state(self, like=None):
        return tuple(s.init_state(like) for s in self.stages)

    def process_block(self, state, x):
        new = []
        for st, stage in zip(state, self.stages):
            st, x = stage.up(st, x)
            new.append(st)
        return tuple(new), x

    def latency_samples(self) -> int:
        k = len(self.stages)
        return 0 if k == 0 else IIR_HALFBAND_GROUP_DELAY * ((1 << k) - 1)


class IirHalfbandDown(IirHalfbandUp):
    def process_block(self, state, x):
        new = []
        for st, stage in zip(state, self.stages):
            st, x = stage.down(st, x)
            new.append(st)
        return tuple(new), x


# --------------------------------------------------------------------- #
def make_upsampler(policy: str, n: int):
    """Kernel factory: policy -> upsampler (reference dispatch tables,
    dispatch/stream.rs:95-104; the default stream policy is the sinc FIR,
    the default value policy the latch)."""
    return {"latch": LatchUp, "linear": LinearUp, "sinc": SincUpFir,
            "sinc_iir": IirHalfbandUp}[policy](n)


def make_downsampler(policy: str, n: int):
    return {"latch": LatchDown, "linear": LinearDown, "sinc": SincDownFir,
            "sinc_iir": IirHalfbandDown}[policy](n)
