"""The port's native host runtime (``oscen_tpu_torch/utils/native.py``):
its own copy of the C++ source, the build into the port's ``_build``
directory, and the cases of ``tests/test_native.py`` — parity with the
Python fallbacks — each also against the JAX package's native library."""

import wave
from pathlib import Path

import numpy as np
import pytest

from oscen_tpu.utils import native as jnative
from oscen_tpu_torch.utils import native

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def lib_available():
    if not native.available():
        pytest.skip("native host runtime not built (no g++?)")
    return True


def test_port_source_is_a_byte_copy():
    """The port builds from its own copy of native/oscen_host.cpp, which
    equals the JAX package's byte for byte."""
    ours = ROOT / "oscen_tpu_torch" / "csrc" / "host" / "oscen_host.cpp"
    assert ours.read_bytes() == (ROOT / "native" / "oscen_host.cpp") \
        .read_bytes()


def test_library_builds_into_the_port(lib_available):
    path = native.library_path()
    assert path.parent == ROOT / "oscen_tpu_torch" / "_build"
    assert path.exists()
    assert not list(path.parent.glob(path.name + ".*.tmp"))


def test_native_midi_parse_parity(lib_available):
    from oscen_tpu_torch.core.events import NoteOffEvent, NoteOnEvent
    from oscen_tpu_torch.nodes.midi import MidiParser

    cases = [[0x90, 60, 100], [0x80, 60, 0], [0x90, 60, 0],
             [0xB0, 1, 1], [0x90, 127, 127], [0xF8]]
    for c in cases:
        n = native.parse_midi(c)
        assert n == jnative.parse_midi(c)
        p = MidiParser.parse_bytes(c)
        if p is None:
            assert n == ("none",)
        elif isinstance(p, NoteOnEvent):
            assert n[0] == "on" and n[1] == p.note
            assert abs(n[2] - p.velocity) < 1e-6
        elif isinstance(p, NoteOffEvent):
            assert n[0] == "off" and n[1] == p.note


def test_native_allocator_parity(lib_available):
    from oscen_tpu_torch.nodes.voice_allocator import VoiceAllocator

    rng = np.random.default_rng(0)
    py = VoiceAllocator(4)
    nat = native.NativeAllocator(4)
    ref = jnative.NativeAllocator(4)
    held = []
    for _ in range(200):
        if held and rng.random() < 0.4:
            note = held.pop(rng.integers(len(held)))
            a = py.find_voice_for_note(note)
            if a is not None:
                py.release_voice(a)
            b = nat.note_off(note)
            assert (a if a is not None else -1) == b == ref.note_off(note)
        else:
            note = int(rng.integers(30, 90))
            if note in held:
                continue
            held.append(note)
            v = py.allocate_voice(note)
            assert v == nat.note_on(note) == ref.note_on(note)


def test_native_resampler_parity(lib_available, monkeypatch):
    """The native resampler against the port's numpy path (< 1e-4, as the
    JAX test), and equal to the JAX package's native resampler."""
    from oscen_tpu_torch.ops import offline_resample as orx

    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, 3000).astype(np.float32)
    for src, dst in [(48000, 44100), (44100, 48000), (48000, 16000)]:
        a = native.resample_channel_native(x, src, dst)
        np.testing.assert_array_equal(
            a, jnative.resample_channel_native(x, src, dst))
        with monkeypatch.context() as m:
            m.setattr(native, "_LIB", None)
            m.setattr(native, "_TRIED", True)
            b = orx.resample_channel(x, src, dst)
        assert a.shape == b.shape
        assert np.abs(a - b).max() < 1e-4, np.abs(a - b).max()


def test_native_resampler_quality(lib_available):
    x = np.full(500, 0.7, np.float32)
    out = native.resample_channel_native(x, 48000, 44100)
    np.testing.assert_allclose(out[36:-36], 0.7, atol=1e-3)


def test_native_wav_decoder_parity_and_float32(tmp_path, lib_available):
    """PCM16 decodes as the stdlib path does; the port's decoder equals the
    JAX package's."""
    from oscen_tpu_torch import AudioAsset

    rng = np.random.default_rng(0)
    audio = rng.uniform(-0.9, 0.9, (1000, 2)).astype(np.float32)
    p16 = str(tmp_path / "a16.wav")
    AudioAsset.write_wav(p16, audio, 44100)
    data, ch, rate = native.decode_wav_native(p16)
    assert (ch, rate) == (2, 44100)
    jd, jch, jrate = jnative.decode_wav_native(p16)
    np.testing.assert_array_equal(data, jd)
    assert (jch, jrate) == (ch, rate)
    a = AudioAsset.from_wav(p16)
    assert a.channels == 2 and a.sample_rate == 44100
    with wave.open(p16, "rb") as w:
        raw = w.readframes(w.getnframes())
    ref = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    np.testing.assert_array_equal(data, ref)
    with pytest.raises(FileNotFoundError):
        native.decode_wav_native(str(tmp_path / "missing.wav"))


def test_fallbacks_when_the_library_is_off(monkeypatch):
    """With the library off every entry point returns None (the callers'
    Python paths run) and ``available()`` says so."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    assert not native.available()
    assert native.parse_midi([0x90, 60, 100]) is None
    assert native.resample_channel_native(np.zeros(4, np.float32), 1,
                                          2) is None
    assert native.decode_wav_native("x.wav") is None
    with pytest.raises(RuntimeError):
        native.NativeAllocator(2)
