"""ctypes loader for the native host runtime (``csrc/host/oscen_host.cpp``).

Counterpart of ``oscen_tpu/utils/native.py``.  The port keeps its own
byte-identical copy of the JAX package's ``native/oscen_host.cpp`` and
builds it with g++ on first use into
``oscen_tpu_torch/_build/liboscen_host-<digest>.so`` (the digest covers the
source and the flags; the build writes a temporary file and renames it, so
concurrent test workers never load a half-written library).  This is a host
library — MIDI parse, the LRU allocator, the offline resampler and the WAV
decoder — not a device kernel.  Every entry point has a pure-Python
fallback; ``available()`` reports which path is live.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_PKG_DIR = Path(__file__).resolve().parents[1]
_SRC = _PKG_DIR / "csrc" / "host" / "oscen_host.cpp"
_BUILD_DIR = _PKG_DIR / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    """Where the built library lives: keyed on the source and the flags."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"liboscen_host-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    if not _SRC.exists():
        return None
    out = library_path()
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except Exception:
        tmp.unlink(missing_ok=True)
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.oscen_parse_midi.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float)]
        lib.oscen_alloc_create.restype = ctypes.c_void_p
        lib.oscen_alloc_create.argtypes = [ctypes.c_int32]
        lib.oscen_alloc_destroy.argtypes = [ctypes.c_void_p]
        lib.oscen_alloc_reset.argtypes = [ctypes.c_void_p]
        lib.oscen_alloc_note_on.restype = ctypes.c_int32
        lib.oscen_alloc_note_on.argtypes = [ctypes.c_void_p,
                                            ctypes.c_int32]
        lib.oscen_alloc_note_off.restype = ctypes.c_int32
        lib.oscen_alloc_note_off.argtypes = [ctypes.c_void_p,
                                             ctypes.c_int32]
        lib.oscen_resample_out_len.restype = ctypes.c_int64
        lib.oscen_resample_out_len.argtypes = [
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
        lib.oscen_resample_channel.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.oscen_wav_info.restype = ctypes.c_int32
        lib.oscen_wav_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.oscen_wav_read.restype = ctypes.c_int32
        lib.oscen_wav_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64]
        _LIB = lib
        return _LIB


def available() -> bool:
    """True when the native library built and loaded (else every entry
    point below returns None and its caller takes the Python path)."""
    return _load() is not None


# --------------------------------------------------------------------- #
def parse_midi(data) -> Optional[tuple]:
    """Returns ('on', note, velocity) | ('off', note) | ('none',), or None
    without the native library."""
    lib = _load()
    if lib is None:
        return None
    buf = (ctypes.c_uint8 * max(len(data), 1))(*[int(b) & 0xFF
                                                 for b in data])
    kind = ctypes.c_int32()
    note = ctypes.c_int32()
    vel = ctypes.c_float()
    lib.oscen_parse_midi(buf, len(data), ctypes.byref(kind),
                         ctypes.byref(note), ctypes.byref(vel))
    if kind.value == 1:
        return ("on", note.value, vel.value)
    if kind.value == 2:
        return ("off", note.value)
    return ("none",)


class NativeAllocator:
    """Native LRU voice allocator (parity with nodes/voice_allocator)."""

    def __init__(self, num_voices: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native host runtime unavailable")
        self._lib = lib
        self._ptr = lib.oscen_alloc_create(num_voices)

    def __del__(self):
        try:
            self._lib.oscen_alloc_destroy(self._ptr)
        except Exception:
            pass

    def reset(self):
        self._lib.oscen_alloc_reset(self._ptr)

    def note_on(self, note: int) -> int:
        return int(self._lib.oscen_alloc_note_on(self._ptr, int(note)))

    def note_off(self, note: int) -> int:
        return int(self._lib.oscen_alloc_note_off(self._ptr, int(note)))


def resample_channel_native(x: np.ndarray, src: int,
                            dst: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    n_out = int(lib.oscen_resample_out_len(len(x), src, dst))
    out = np.zeros((n_out,), np.float32)
    lib.oscen_resample_channel(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
        src, dst, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_out)
    return out


def decode_wav_native(path: str):
    """Native WAV decode: (interleaved float32 [frames*channels],
    channels, rate), or None without the native library; raises
    FileNotFoundError for a missing file and ValueError on a corrupt or
    unsupported one.  Reads PCM 8/16/24/32 and IEEE float32, including
    WAVE_FORMAT_EXTENSIBLE (the stdlib ``wave`` module reads no float
    WAVs)."""
    lib = _load()
    if lib is None:
        return None
    ch = ctypes.c_int32()
    rate = ctypes.c_int32()
    frames = ctypes.c_int64()
    fmt = ctypes.c_int32()
    bits = ctypes.c_int32()
    rc = lib.oscen_wav_info(path.encode(), ctypes.byref(ch),
                            ctypes.byref(rate), ctypes.byref(frames),
                            ctypes.byref(fmt), ctypes.byref(bits))
    if rc == -1:
        raise FileNotFoundError(path)
    if rc != 0:
        raise ValueError(f"unsupported or corrupt WAV: {path}")
    total = int(frames.value) * int(ch.value)
    out = np.empty((max(total, 1),), np.float32)
    rc = lib.oscen_wav_read(path.encode(),
                            out.ctypes.data_as(
                                ctypes.POINTER(ctypes.c_float)),
                            len(out))
    if rc != 0:
        raise ValueError(f"failed to read WAV data: {path} (rc={rc})")
    return out[:total], int(ch.value), int(rate.value)
