"""Audio assets (``oscen_tpu_torch.assets``) and the offline resampler
(``ops/offline_resample.py``) against the JAX package on the CPU, bit for
bit.

Both are numpy on the host in both packages.  The resampler asks the
native host library first: each case runs once with it and once with it
switched off in both packages (the numpy path), and the two packages agree
bit for bit on either path.  ``AudioAsset.from_samples`` / ``from_wav`` /
``write_wav`` equal the JAX package's (arrays and file bytes).  The
offline-resampler quality cases of ``tests/test_assets_convolution.py``
run on the port.
"""

import struct
import wave

import numpy as np
import pytest

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.ops import offline_resample as jrs
from oscen_tpu.utils import native as jnative
from oscen_tpu_torch.ops import offline_resample as trs
from oscen_tpu_torch.utils import native as tnative

PATHS = ["native", "numpy"]


@pytest.fixture
def path(request, monkeypatch):
    """Switch both packages' native library off for the numpy path."""
    if request.param == "native":
        if not (jnative.available() and tnative.available()):
            pytest.skip("native host runtime not built (no g++?)")
    else:
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_TRIED", True)
    return request.param


def _both_resample(x, src, dst):
    a = jrs.resample_channel(x, src, dst)
    b = trs.resample_channel(x, src, dst)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(b, a)
    return b


@pytest.mark.parametrize("path", PATHS, indirect=True)
@pytest.mark.parametrize("src,dst", [(48000, 44100), (44100, 48000),
                                     (96000, 44100), (48000, 16000),
                                     (22050, 48000), (48000, 48000)])
def test_offline_resample_equals_jax(path, src, dst):
    x = np.random.default_rng(src + dst).uniform(-1, 1, 1500).astype(
        np.float32)
    _both_resample(x, src, dst)


@pytest.mark.parametrize("path", PATHS, indirect=True)
def test_offline_resample_constant_preserved(path):
    x = np.full(500, 0.7, np.float32)
    for src, dst in [(48000, 44100), (44100, 48000), (96000, 44100)]:
        out = _both_resample(x, src, dst)
        np.testing.assert_allclose(out[36:-36], 0.7, atol=1e-3)


@pytest.mark.parametrize("path", PATHS, indirect=True)
def test_offline_resample_sine_preserved(path):
    src, dst, freq = 48000, 44100, 1000.0
    t = np.arange(24000, dtype=np.float32)
    x = np.sin(2 * np.pi * freq * t / src).astype(np.float32)
    out = _both_resample(x, src, dst)
    t2 = np.arange(len(out), dtype=np.float32)
    want = np.sin(2 * np.pi * freq * t2 / dst)
    assert np.abs(out[40:-40] - want[40:-40]).max() < 1e-2


@pytest.mark.parametrize("path", PATHS, indirect=True)
def test_offline_resample_rejects_above_nyquist(path):
    src, dst = 48000, 16000
    t = np.arange(24000, dtype=np.float32)
    x = np.sin(2 * np.pi * 12000.0 * t / src).astype(np.float32)
    out = _both_resample(x, src, dst)
    assert np.abs(out[40:-40]).max() < 0.1


def test_offline_resample_lengths():
    x = np.zeros(1000, np.float32)
    assert len(trs.resample_channel(x, 48000, 24000)) == 500
    assert len(trs.resample_channel(x, 24000, 48000)) == 2000
    assert len(trs.resample_channel(x, 48000, 48000)) == 1000
    assert len(trs.resample_channel(np.zeros(0, np.float32), 1, 2)) == 0


# ------------------------------------------------------------------ #
# AudioAsset
# ------------------------------------------------------------------ #
def _assets_equal(a, b):
    assert type(b).__name__ == "AudioAsset"
    assert b.sample_rate == a.sample_rate
    assert b.channels_data.dtype == np.float32
    np.testing.assert_array_equal(b.channels_data, a.channels_data)


@pytest.mark.parametrize("layout", ["mono", "interleaved", "ch_frames",
                                    "frames_ch"])
@pytest.mark.parametrize("graph_rate", [None, 48000.0, 32000.0])
def test_from_samples_equals_jax(layout, graph_rate):
    rng = np.random.default_rng(7)
    data = rng.uniform(-1, 1, (2, 300)).astype(np.float32)
    args = {"mono": (data[0], 1), "interleaved": (data.T.reshape(-1), 2),
            "ch_frames": (data, 1), "frames_ch": (data.T, 1)}[layout]
    a = J.AudioAsset.from_samples(args[0], 44100, args[1], graph_rate)
    b = T.AudioAsset.from_samples(args[0], 44100, args[1], graph_rate)
    _assets_equal(a, b)
    np.testing.assert_array_equal(b.to_mono(), a.to_mono())
    assert (b.channels, b.frames) == (a.channels, a.frames)


@pytest.mark.parametrize("bad", [
    dict(samples=np.zeros(5, np.float32), sample_rate=48000, channels=2),
    dict(samples=np.zeros(4, np.float32), sample_rate=0),
    dict(samples=np.zeros((2, 2, 2), np.float32), sample_rate=48000)])
def test_asset_errors_match_jax(bad):
    with pytest.raises(J.AssetError) as ej:
        J.AudioAsset.from_samples(**bad)
    with pytest.raises(T.AssetError) as et:
        T.AudioAsset.from_samples(**bad)
    assert str(et.value) == str(ej.value)
    assert issubclass(T.AssetError, ValueError)


def _write_pcm(path, frames, width, channels, rate):
    """A PCM WAV of ``width`` bytes per sample through the stdlib."""
    rng = np.random.default_rng(width)
    if width == 1:
        raw = rng.integers(0, 256, frames * channels, dtype=np.uint8)
        payload = raw.tobytes()
    elif width == 3:
        vals = rng.integers(-(1 << 23), 1 << 23, frames * channels)
        payload = b"".join(int(v & 0xFFFFFF).to_bytes(3, "little")
                           for v in vals)
    else:
        dt = {2: "<i2", 4: "<i4"}[width]
        info = np.iinfo(dt)
        payload = rng.integers(info.min, info.max, frames * channels,
                               dtype=dt).tobytes()
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(payload)


@pytest.mark.parametrize("path", PATHS, indirect=True)
@pytest.mark.parametrize("width,channels", [(1, 1), (2, 2), (3, 1), (4, 2)])
@pytest.mark.parametrize("graph_rate", [None, 48000.0])
def test_from_wav_equals_jax(tmp_path, path, width, channels, graph_rate):
    p = str(tmp_path / f"w{width}.wav")
    _write_pcm(p, 400, width, channels, 44100)
    _assets_equal(J.AudioAsset.from_wav(p, graph_rate),
                  T.AudioAsset.from_wav(p, graph_rate))


def test_float32_wav_and_corrupt_files(tmp_path):
    """An IEEE-float32 WAV (the native decoder reads it, the stdlib cannot)
    and a corrupt file, through both packages."""
    if not (jnative.available() and tnative.available()):
        pytest.skip("native host runtime not built (no g++?)")
    x = np.sin(np.linspace(0, 20, 500)).astype(np.float32)
    pf = str(tmp_path / "f32.wav")
    payload = x.tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, 48000, 48000 * 4, 4, 32)
    with open(pf, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8
                                      + len(payload)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(payload)) + payload)
    b = T.AudioAsset.from_wav(pf)
    _assets_equal(J.AudioAsset.from_wav(pf), b)
    np.testing.assert_array_equal(b.channel(0), x)
    pc = str(tmp_path / "bad.wav")
    open(pc, "wb").write(b"RIFFxxxxJUNK")
    for pkg in (J, T):
        with pytest.raises(pkg.AssetError):
            pkg.AudioAsset.from_wav(pc)
        with pytest.raises(pkg.AssetError):
            pkg.AudioAsset.from_wav(str(tmp_path / "missing.wav"))


@pytest.mark.parametrize("shape", [(300,), (300, 2)])
def test_write_wav_equals_jax(tmp_path, shape):
    audio = np.random.default_rng(3).uniform(-1.2, 1.2, shape).astype(
        np.float32)
    pj, pt = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    J.AudioAsset.write_wav(pj, audio, 44100)
    T.AudioAsset.write_wav(pt, audio, 44100)
    assert open(pt, "rb").read() == open(pj, "rb").read()
