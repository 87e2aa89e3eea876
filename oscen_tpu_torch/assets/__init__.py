"""Audio assets: immutable channel-major sample data + load pipeline.

Copy of ``oscen_tpu/assets/__init__.py``: the data stays numpy on the host
until a node consumes it (``CompiledGraph.publish_asset``).  Counterpart
of the reference's asset subsystem (asset/mod.rs): decode a WAV (or
accept raw samples), deinterleave to channel-major, conform to the graph
rate with the offline windowed-sinc resampler, then hand the playable to
the audio side.

The reference's lock-free handoff (publish → take → retire,
handoff/mod.rs) maps to the host↔device boundary: publishing builds the
playable on the host, copies it to the card from pinned memory without
waiting, and replaces the consuming node's state between blocks; the old
tensors are dropped by the host, never by the render path.
"""

from __future__ import annotations

import wave
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..ops.offline_resample import resample_channel

__all__ = ["AudioAsset", "AssetError"]


class AssetError(ValueError):
    """Load/conform error (reference asset/mod.rs:26-46).  Raised on the
    control side only — the render path never sees it."""


@dataclass
class AudioAsset:
    """Immutable deinterleaved channel-major audio at a known rate."""

    channels_data: np.ndarray  # [channels, frames] float32
    sample_rate: int

    # ------------------------------------------------------------------ #
    @property
    def channels(self) -> int:
        return int(self.channels_data.shape[0])

    @property
    def frames(self) -> int:
        return int(self.channels_data.shape[1])

    def channel(self, c: int) -> np.ndarray:
        return self.channels_data[c]

    def to_mono(self) -> np.ndarray:
        """Average all channels (reference convolution channel-mapping
        convention)."""
        return self.channels_data.mean(axis=0).astype(np.float32)

    # ------------------------------------------------------------------ #
    @staticmethod
    def from_samples(samples: np.ndarray, sample_rate: int,
                     channels: int = 1,
                     graph_rate: Optional[float] = None) -> "AudioAsset":
        """Build from interleaved (or [frames, ch] / [ch, frames]) samples,
        conforming to ``graph_rate`` via the offline resampler
        (reference asset/mod.rs:169-232)."""
        if sample_rate <= 0:
            raise AssetError("sample rate must be positive")
        s = np.asarray(samples, np.float32)
        if s.ndim == 1:
            if channels <= 0 or len(s) % channels:
                raise AssetError(
                    f"interleaved length {len(s)} not divisible by "
                    f"{channels} channels")
            ch = s.reshape(-1, channels).T
        elif s.ndim == 2:
            ch = s if s.shape[0] <= s.shape[1] else s.T
        else:
            raise AssetError("samples must be 1-D interleaved or 2-D")
        ch = np.ascontiguousarray(ch, np.float32)
        rate = int(sample_rate)
        if graph_rate is not None and int(graph_rate) != rate:
            dst = int(graph_rate)
            ch = np.stack([resample_channel(c, rate, dst) for c in ch])
            rate = dst
        return AudioAsset(ch, rate)

    @staticmethod
    def from_wav(path: str,
                 graph_rate: Optional[float] = None) -> "AudioAsset":
        """Decode a PCM/float WAV (reference asset/mod.rs:138-155, which
        uses the native hound decoder).  The native C++ decoder
        (csrc/host/oscen_host.cpp) is preferred — it also reads IEEE-float
        and WAVE_FORMAT_EXTENSIBLE files the stdlib module cannot; the
        stdlib path is the fallback."""
        from ..utils.native import decode_wav_native
        try:
            native = decode_wav_native(path)
        except FileNotFoundError as e:
            raise AssetError(f"failed to decode WAV '{path}': {e}") from e
        except ValueError:
            native = None  # fall back to the stdlib decoder's diagnostics
        if native is not None:
            data, n_ch, rate = native
            return AudioAsset.from_samples(data, rate, n_ch, graph_rate)
        try:
            with wave.open(path, "rb") as w:
                n_ch = w.getnchannels()
                width = w.getsampwidth()
                rate = w.getframerate()
                n = w.getnframes()
                raw = w.readframes(n)
        except (wave.Error, EOFError, OSError) as e:
            raise AssetError(f"failed to decode WAV '{path}': {e}") from e
        if width == 2:
            data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif width == 4:
            data = np.frombuffer(raw, "<i4").astype(np.float32) \
                / 2147483648.0
        elif width == 3:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            vals = (b[:, 0].astype(np.int32)
                    | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16))
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            data = vals.astype(np.float32) / float(1 << 23)
        elif width == 1:
            data = (np.frombuffer(raw, np.uint8).astype(np.float32)
                    - 128.0) / 128.0
        else:
            raise AssetError(f"unsupported WAV sample width {width}")
        return AudioAsset.from_samples(data, rate, n_ch, graph_rate)

    # ------------------------------------------------------------------ #
    @staticmethod
    def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
        """Write mono [N] or multi-channel [N, C] float32 audio as 16-bit
        PCM (utility for offline rendering, render_convolution.rs-style)."""
        a = np.asarray(audio, np.float32)
        if a.ndim == 1:
            a = a[:, None]
        pcm = (np.clip(a, -1.0, 1.0) * 32767.0).astype("<i2")
        with wave.open(path, "wb") as w:
            w.setnchannels(a.shape[1])
            w.setsampwidth(2)
            w.setframerate(int(sample_rate))
            w.writeframes(pcm.tobytes())
