"""Zero-latency impulse-response convolver with live IR hot-swap.

Counterpart of ``oscen_tpu/nodes/convolver.py`` (the reference Convolver,
convolution/mod.rs): sample-exact full convolution with no latency,
per-channel engines (L→L, R→R, no cross terms), and a 20 ms equal-power
crossfade on live IR swaps with at most two engines alive.  The state has
the JAX package's keys, shapes and dtypes.

Block mode runs a **uniform-partition frequency-domain delay line at the
graph block size** (``ops/conv.py``): per block one 2B-point rFFT of the
sliding input window, a spectral MAC against the IR partition spectra
carried in state (``fdl [P, B+1, C]`` complex64, ``h_cur``, ``h_old``),
and one irFFT.  One input FFT serves both engines during a crossfade.

The JAX package picks the crossfade branch with ``lax.cond`` on the
device's ``fade_pos``.  Reading ``fade_pos`` from the card would make every
block wait for it, and taking both branches always would double the MAC
and the irFFT for good.  The host knows ``fade_pos`` exactly — a publish
sets it to 0 and each block adds its length up to the fade length — so
``CompiledGraph`` keeps a host mirror of it (``HOST_MIRROR``,
:meth:`Convolver.mirror_step`) and the block takes the branch from the
mirror (``host_mirror``).  After the fade a steady block is one rFFT, the
MAC and one irFFT.

A ragged block (the offline tail) convolves directly over the time-domain
window and rebuilds the FDL from the history.  IRs longer than the capacity
grow it to the next power of two of partitions; the FDL pads with zero
partitions.  Sample mode (:meth:`Convolver.tick`) shifts ``past`` by one
sample and takes the dot product with the IR, as the JAX package's tick.

``process_block`` takes a leading instance axis (``BATCHED``): a node
array of convolvers is one call; ``tick`` broadcasts over it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..assets import AudioAsset
from ..core.types import SampleRate, asset, stream
from ..graph.node import Node, to_device
from ..ops import fmath
from ..ops.conv import BlockConvolver, irfft, rfft

CROSSFADE_SECONDS = 0.02  # reference convolution/mod.rs:468-469
DEFAULT_MAX_IR = 4096


def _next_pow2(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


class Convolver(Node):
    BATCHED = True
    # state leaves CompiledGraph keeps a host copy of (mirror_step)
    HOST_MIRROR = ("fade_pos",)

    def __init__(self, ir=None, max_ir_len: int = DEFAULT_MAX_IR,
                 channels: int = 1):
        self.channels = int(channels)
        self.capacity = int(max_ir_len)
        self._initial_ir = None if ir is None else np.asarray(
            ir, np.float32)
        if self._initial_ir is not None \
                and len(self._initial_ir) > self.capacity:
            self.capacity = _next_pow2(len(self._initial_ir))
        self.INPUTS = (stream("input", 0.0, channels=channels),
                       asset("ir"))
        self.OUTPUTS = (stream("output", channels=channels),)

    @classmethod
    def with_ir(cls, ir, channels: int = 1) -> "Convolver":
        """Mono IR baked in at construction, broadcast to every channel
        (reference convolution/mod.rs:494-499)."""
        return cls(ir=ir, channels=channels)

    # ------------------------------------------------------------------ #
    def _initial_ir_buffer(self, cap: int) -> np.ndarray:
        ir = np.zeros((cap, self.channels), np.float32)
        if self._initial_ir is not None:
            ir[:len(self._initial_ir), :] = self._initial_ir[:, None]
        return ir

    def init_state(self, sr: SampleRate):
        cap, C = self.capacity, self.channels
        return {
            "past": torch.zeros((cap, C)),  # chronological
            "ir_cur": torch.from_numpy(self._initial_ir_buffer(cap)),
            "ir_old": torch.zeros((cap, C)),
            # >= the fade length: not fading
            "fade_pos": torch.tensor(self._fade_len(sr), dtype=torch.int32),
        }

    def init_block_state(self, sr: SampleRate, block_len: int):
        """FDL extension of the state (block mode only): the input-spectrum
        delay line and the IR partition spectra.  The time-domain buffers
        take the engine's partition-aligned capacity; ``past`` keeps
        (P+1)·B samples so the FDL can be rebuilt exactly after a ragged
        block."""
        eng = BlockConvolver(block_len, self.capacity)
        C = self.channels
        cap = eng.partitions * eng.block
        ir = self._initial_ir_buffer(cap)
        h_cur = torch.from_numpy(eng.ir_spectra(ir))
        return {
            "past": torch.zeros((cap + eng.block, C)),
            "ir_cur": torch.from_numpy(ir),
            "ir_old": torch.zeros((cap, C)),
            "fdl": torch.zeros((eng.partitions, eng.nbins, C),
                               dtype=torch.complex64),
            "h_cur": h_cur,
            "h_old": torch.zeros_like(h_cur),
        }

    def _fade_len(self, sr: SampleRate) -> int:
        return max(int(round(CROSSFADE_SECONDS * sr.hz)), 1)

    def mirror_step(self, mirror, sr: SampleRate, n: int = 0,
                    consumed: bool = False):
        """The host mirror of ``fade_pos`` after a publish (``consumed``)
        or after a block of ``n`` samples."""
        if consumed:
            return {"fade_pos": 0}
        return {"fade_pos": min(mirror["fade_pos"] + n,
                                self._fade_len(sr))}

    # ------------------------------------------------------------------ #
    def asset_consume(self, state, a: AudioAsset, sr: SampleRate):
        """Live IR swap: fade from the outgoing engine to the new one
        (reference convolution/mod.rs:534-573).  Channel mapping per
        MultiConvolverEngine::from_asset.  IRs longer than the capacity
        grow the engine (power-of-two capacity classes), never truncate.

        Nothing here reads the card: the new IR and its spectra are built
        on the host and copied from pinned memory without waiting; the
        outgoing engine's spectra are the current ``h_cur`` (the same
        numpy function of the same IR), padded with zero partitions when
        the capacity grows."""
        C = self.channels
        ir_len = max(len(a.channel(0)), 1)
        B = None
        if "fdl" in state:
            B = int(state["fdl"].shape[1]) - 1  # nbins = B + 1
            P = int(state["fdl"].shape[0])
            cap = P * B
            if ir_len > cap:
                P = _next_pow2(-(-ir_len // B))
                cap = P * B
        else:
            cap = int(state["past"].shape[0])
            if ir_len > cap:
                cap = _next_pow2(ir_len)

        ir = np.zeros((cap, C), np.float32)
        src_ch = a.channels
        if C == 1 and src_ch > 1:
            mono = a.to_mono()
            ir[:min(len(mono), cap), 0] = mono[:cap]
        else:
            for c in range(C):
                sc = 0 if src_ch == 1 else min(c, src_ch - 1)
                data = a.channel(sc)
                ir[:min(len(data), cap), c] = data[:cap]

        dev = state["past"].device
        # past keeps cap samples (sample mode) / cap+B samples (block mode)
        past_len = cap if B is None else cap + B
        old_past_len = int(state["past"].shape[0])
        old_cap = int(state["ir_cur"].shape[0])
        past = state["past"]
        if past_len > old_past_len:
            # history is chronological (past[-1] = newest): pad oldest end
            past = torch.cat([torch.zeros((past_len - old_past_len, C),
                                          device=dev), past])
        ir_old = state["ir_cur"]
        if cap > old_cap:
            ir_old = torch.cat([ir_old, torch.zeros((cap - old_cap, C),
                                                    device=dev)])
        new = {**state, "past": past, "ir_old": ir_old,
               "ir_cur": to_device(ir, dev),
               "fade_pos": torch.zeros((), dtype=torch.int32, device=dev)}
        if "fdl" in state:
            eng = BlockConvolver(B, cap)
            new["h_cur"] = to_device(eng.ir_spectra(ir), dev)
            grow = eng.partitions - int(state["fdl"].shape[0])
            h_old, fdl = state["h_cur"], state["fdl"]
            if grow > 0:
                pad = torch.zeros((grow, eng.nbins, C),
                                  dtype=torch.complex64, device=dev)
                h_old = torch.cat([h_old, pad])
                fdl = torch.cat([fdl, pad])
            new["h_old"] = h_old
            new["fdl"] = fdl
        return new

    # ------------------------------------------------------------------ #
    def _gains(self, pos, fade_len):
        """The equal-power crossfade gains at fade positions ``pos``
        (int32), as the JAX package computes them under ``jit``."""
        g = fmath.div_const(pos.to(torch.float32), float(fade_len))
        g = torch.clamp(g, 0.0, 1.0) * (math.pi / 2.0)
        return fmath.sin(g), fmath.cos(g)

    def tick(self, state, ins, sr):
        x = ins["input"]
        if self.channels == 1:
            x = x[..., None]                                # [..., C]
        past = torch.cat([state["past"][..., 1:, :], x[..., None, :]],
                         dim=-2)
        rev = past.flip(-2)  # rev[k] = x[t-k]
        y_new = torch.sum(rev * state["ir_cur"], dim=-2)
        fade_len = self._fade_len(sr)
        fading = state["fade_pos"] < fade_len
        y_old = torch.sum(rev * state["ir_old"], dim=-2)
        gain_new, gain_old = self._gains(state["fade_pos"], fade_len)
        out = torch.where(fading[..., None],
                          y_new * gain_new[..., None]
                          + y_old * gain_old[..., None], y_new)
        fade_pos = torch.where(fading, state["fade_pos"] + 1,
                               state["fade_pos"])
        if self.channels == 1:
            out = out[..., 0]
        return ({**state, "past": past, "fade_pos": fade_pos},
                {"output": out})

    def process_block(self, state, ins, events, sr, block_len, host_mirror):
        """One block over ``[N, ...]`` instances.  ``host_mirror`` (the
        host's ``fade_pos``, the same for every instance: one publish
        reaches them all) picks the steady block's branch."""
        n = block_len
        P = int(state["fdl"].shape[1])
        Bf = int(state["fdl"].shape[2]) - 1  # FDL partition block size
        cap = P * Bf
        past_len = int(state["past"].shape[1])  # == cap + Bf
        x = ins["input"]
        if self.channels == 1:
            x = x[..., None]                                 # [N, n, C]
        eng = BlockConvolver(Bf, cap, axis=1)
        fade_len = self._fade_len(sr)
        fade_pos = state["fade_pos"]
        past = torch.cat([state["past"], x], dim=1)[:, -past_len:]

        def gains():
            pos = fade_pos[:, None] + torch.arange(n, dtype=torch.int32,
                                                   device=x.device)
            g_new, g_old = self._gains(pos, fade_len)
            return g_new[..., None], g_old[..., None]

        if n == Bf:
            # steady path: roll the FDL, one input FFT serves both engines
            fdl_state = {"fdl": state["fdl"], "prev": state["past"][:, -Bf:]}
            fdl_state, fdl = eng.spectral_mac(fdl_state, x)
            y_new = eng.apply(fdl, state["h_cur"])
            new_fdl = fdl_state["fdl"]
            if host_mirror["fade_pos"] >= fade_len:
                out = y_new
            else:
                y_old = eng.apply(fdl, state["h_old"])
                gain_new, gain_old = gains()
                out = y_new * gain_new + y_old * gain_old
        else:
            # ragged block (offline-render tail): exact direct conv over
            # the time-domain window, then rebuild the FDL from history so
            # subsequent full blocks stay aligned
            window = torch.cat([state["past"][:, -cap:], x], dim=1)
            L = _next_pow2(cap + n)
            S = rfft(window, n=L, dim=1)

            def conv_with(ir):
                H = rfft(ir, n=L, dim=1)
                y = irfft(S * H, n=L, dim=1)
                return y[:, cap:cap + n].to(torch.float32)

            y_new = conv_with(state["ir_cur"])
            y_old = conv_with(state["ir_old"])
            gain_new, gain_old = gains()
            out = y_new * gain_new + y_old * gain_old
            # rebuild: fdl[p] = rfft of the (p+1)-to-p trailing B-blocks
            N = past.shape[0]
            blocks = past.reshape((N, P + 1, Bf) + tuple(past.shape[2:]))
            wins = torch.cat([blocks[:, :-1], blocks[:, 1:]], dim=2)
            new_fdl = rfft(wins, dim=2).to(torch.complex64).flip(1)

        fade_pos = torch.clamp(fade_pos + n, max=fade_len)
        if self.channels == 1:
            out = out[..., 0]
        return ({**state, "past": past, "fdl": new_fdl,
                 "fade_pos": fade_pos}, {"output": out})
