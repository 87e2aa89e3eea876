"""Impulse-response convolution — frequency-domain delay line.

Counterpart of ``oscen_tpu/ops/conv.py``.  The reference reaches
zero-latency convolution with a 3-tier Gardner decomposition (a direct head
and two FFT stages, convolution/mod.rs) because it streams per sample.  A
block engine needs no tiers: a **uniform-partition frequency-domain delay
line at the graph block size** applies partition 0 (lags ``[0, B)``) to the
current input block, so the full convolution comes out sample-exact with
zero latency.

The FFTs are ``torch.fft`` (cuFFT on the card, pocketfft on the CPU), as
the JAX package's are XLA's ``jnp.fft`` outside any Pallas kernel.  The IR
partition spectra are computed on the host with numpy (``ir_spectra``,
complex64), the same function as the JAX package's, so the spectra the
port uploads equal JAX's bit for bit.  ``launches`` counts the FFT calls of
this module on any device (``rfft`` and ``irfft``), as a kernel wrapper
counts its launches: a steady block of the Convolver runs one of each, and
one more ``irfft`` during a crossfade.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["BlockConvolver", "direct_conv_block", "launches",
           "reset_launches"]

# FFT calls made through rfft / irfft below (every device)
launches: Dict[str, int] = {"rfft": 0, "irfft": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def rfft(x: torch.Tensor, n=None, dim: int = 0) -> torch.Tensor:
    launches["rfft"] += 1
    return torch.fft.rfft(x, n=n, dim=dim)


def irfft(x: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
    launches["irfft"] += 1
    return torch.fft.irfft(x, n=n, dim=dim)


def direct_conv_block(x, hist, taps):
    """Brute-force time-domain FIR over a block with carried history (the
    reference DirectConvolver).  ``hist``: [T-1, ...]; returns (y,
    new_hist)."""
    T = taps.shape[0]
    z = torch.cat([hist, x], dim=0)
    y = torch.zeros_like(x)
    for k in range(T):
        y = y + taps[k] * z[T - 1 - k:T - 1 - k + x.shape[0]]
    return y, z[-(T - 1):] if T > 1 else hist


class BlockConvolver:
    """Uniform-partition FDL convolver for blocks of ``block_size``.

    ``partitions`` spectra cover an IR of up to ``partitions*block_size``
    taps.  Per block: one rFFT of the sliding 2B window, a spectral MAC
    over all partitions, one irFFT; the alias-free second half is the
    output (overlap-save).  ``axis`` is the time axis of the blocks (0, or
    1 behind a leading instance axis); the state's partition axis sits
    there too (``fdl [..., P, B+1, ...]``, ``prev [..., B, ...]``).
    """

    def __init__(self, block_size: int, max_ir_len: int, axis: int = 0):
        if block_size <= 0:
            raise ValueError("block size must be positive")
        self.block = int(block_size)
        self.partitions = max(1, -(-int(max_ir_len) // self.block))
        self.fft_size = 2 * self.block
        self.nbins = self.block + 1
        self.axis = int(axis)

    # ------------------------------------------------------------------ #
    def ir_spectra(self, ir: np.ndarray) -> np.ndarray:
        """Per-partition spectra ``[P, nbins, ...]`` complex64 of a
        (possibly shorter) IR ``[len, ...]`` (numpy, on the host); excess
        capacity zero-pads.  Trailing dims (channels) pass through."""
        ir = np.asarray(ir, np.float32)
        cap = self.partitions * self.block
        if len(ir) > cap:
            raise ValueError(
                f"IR length {len(ir)} exceeds capacity {cap}")
        trailing = ir.shape[1:]
        padded = np.zeros((cap,) + trailing, np.float32)
        padded[:len(ir)] = ir
        parts = padded.reshape((self.partitions, self.block) + trailing)
        buf = np.zeros((self.partitions, self.fft_size) + trailing,
                       np.float32)
        buf[:, :self.block] = parts
        return np.fft.rfft(buf, axis=1).astype(np.complex64)

    def init_state(self, trailing: Tuple[int, ...] = (), device="cpu"):
        return {
            "fdl": torch.zeros((self.partitions, self.nbins) + trailing,
                               dtype=torch.complex64, device=device),
            "prev": torch.zeros((self.block,) + trailing,
                                dtype=torch.float32, device=device),
        }

    def process_block(self, state, h_spec, x):
        """One block: push x, return the exact convolution segment.
        ``h_spec``: [P, nbins, ...] complex; ``x``: [B, ...].  Returns
        (state', y [B, ...])."""
        state, fdl = self.spectral_mac(state, x)
        return state, self.apply(fdl, h_spec)

    def spectral_mac(self, state, x):
        """Push x and return the updated state and fdl, so that several IR
        sets can be applied to one input spectrum (the crossfade)."""
        a = self.axis
        window = torch.cat([state["prev"], x], dim=a)
        X = rfft(window, dim=a)
        old = state["fdl"]
        fdl = torch.cat([X.unsqueeze(a), old.narrow(a, 0, old.shape[a] - 1)],
                        dim=a)
        return {"fdl": fdl, "prev": x}, fdl

    def apply(self, fdl, h_spec):
        a = self.axis
        Y = torch.sum(h_spec * fdl, dim=a)
        y = irfft(Y, n=self.fft_size, dim=a)
        return y.narrow(a, self.block, self.block).to(torch.float32)
