"""The port's seven examples (``oscen_tpu_torch/examples``) on the CPU,
each at 0.2 s of audio or less: the WAV is written, the output is finite
and not silent, and it matches the JAX package playing the same schedule
on the same model, built directly (the JAX scripts' lengths are fixed),
within the port-against-JAX bound that the model's own
``tests/test_torch_*.py`` pins.
"""

import importlib
import wave

import numpy as np
import pytest

import oscen_tpu as J
from oscen_tpu.models.electric_piano import build_electric_piano as jpiano
from oscen_tpu.models.fm_synth import build_fm_synth as jfm
from oscen_tpu.models.pivot import build_pivot as jpivot
from oscen_tpu.models.poly_synth import build_poly_synth as jpoly
from oscen_tpu.models.simple import build_simple_synth as jsynth
from oscen_tpu.utils.host import StreamingHost as JHost
from oscen_tpu_torch.examples import to_numpy

SECONDS = 0.2


def _ex(name):
    return importlib.import_module(f"oscen_tpu_torch.examples.{name}")


def _piano():
    ex = _ex("electric_piano_demo")
    return to_numpy(ex.render(jpiano(16).compile(ex.SR, block_size=ex.BLOCK),
                              SECONDS, J.raw_midi_event))


def _fm():
    ex = _ex("fm_synth_demo")
    return to_numpy(ex.render(jfm(8).compile(ex.SR, block_size=ex.BLOCK),
                              SECONDS, J.raw_midi_event))


def _pivot():
    ex = _ex("pivot_demo")
    return to_numpy(ex.render(jpivot(8).compile(ex.SR, block_size=ex.BLOCK),
                              SECONDS, J.raw_midi_event))


def _saturator():
    ex = _ex("oversampled_saturator")
    n = int(ex.SR * SECONDS)
    return np.stack([
        np.asarray(ex.build_saturator(f, J).compile(ex.SR, block_size=512)
                   .render_mono(n)) for f in ex.FACTORS])


def _convolution():
    ex = _ex("render_convolution")
    c = ex.build_reverb(J).compile(sample_rate=ex.SR, block_size=512)
    return ex.render(c, J.AudioAsset, None, SECONDS / 2, SECONDS / 2)


def _simple():
    return np.asarray(jsynth().compile(sample_rate=48000.0, block_size=512)
                      .render_mono(int(48000 * SECONDS)))


def _streaming():
    ex = _ex("streaming_host_demo")
    synth = jpoly(8).compile(48000.0, block_size=128, mode="block")
    return JHost(synth, realtime=False).run(
        SECONDS, on_block=ex.live_controls(J.raw_midi_event))


def _within(atol):
    def check(got, want):
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    return check


def _rms_within(bound):
    def check(got, want):
        assert np.sqrt(np.mean((got - want) ** 2)) <= bound
    return check


# name: (argv after the output path, the JAX run, the check against it)
CASES = {
    # The port's steady blocks run the fused v4 closed forms; the JAX
    # package's on the CPU its composed voice.  Over 20 blocks of 480 the
    # two sit 2.3e-4 apart (peak 3.9), inside the JAX package's own bound
    # between those two paths (~5e-4, tests/test_electric_piano.py:317-323;
    # tests/test_torch_electric_piano.py pins 1e-4 over 8 blocks of 64).
    "electric_piano_demo": ([], _piano, _within(5e-4)),
    # tests/test_torch_fm_synth.py
    "fm_synth_demo": ([], _fm, _within(1e-5)),
    # Operator-3 feedback 0.3 from the first block amplifies ulp-level
    # differences: on this schedule the JAX package's own pivot_chain3
    # kernel (interpret mode) and its ticks differ by 5.5e-4 RMS (2.0e-2
    # max), and the port sits 1.1e-5 RMS from that kernel.  Held at 1e-3
    # RMS against the ticks (tests/test_torch_fm_synth.py pins 1e-4 RMS
    # over 3 blocks of 64 with the feedback on).
    "pivot_demo": ([], _pivot, _rms_within(1e-3)),
    # tests/test_torch_echo_saturator.py
    "oversampled_saturator": ([], _saturator, _within(1e-6)),
    # tests/test_torch_convolution.py
    "render_convolution": (["--tail", str(SECONDS / 2)], _convolution,
                           _within(1e-5)),
    # tests/test_torch_poly_synth.py (the README synth and the poly synth)
    "simple_synth": ([], _simple, _within(1e-5)),
    "streaming_host_demo": ([], _streaming, _within(1e-5)),
}


def _argv(name, tmp_path):
    extra = CASES[name][0]
    if name == "streaming_host_demo":
        out = tmp_path / "streaming.wav"
        return [str(SECONDS), "--out", str(out)], out
    if name == "oversampled_saturator":
        return ([str(tmp_path / "sat"), "--seconds", str(SECONDS)],
                tmp_path / "sat_8x.wav")
    out = tmp_path / f"{name}.wav"
    if name == "render_convolution":
        # no IR path: the seeded noise IR
        return ["", str(out), "--seconds", str(SECONDS / 2)] + extra, out
    return [str(out), "--seconds", str(SECONDS)] + extra, out


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_and_matches_jax(name, tmp_path):
    argv, wav = _argv(name, tmp_path)
    got = _ex(name).main(argv + ["--device", "cpu"])
    assert isinstance(got, np.ndarray)
    n = int(48000 * SECONDS) if name != "oversampled_saturator" \
        else int(44100 * SECONDS)
    assert got.shape[-1 if name == "oversampled_saturator" else 0] == n
    assert np.isfinite(got).all()
    assert np.abs(got).max() > 0.01
    with wave.open(str(wav), "rb") as w:
        assert w.getnframes() == n
    want = CASES[name][1]()
    assert want.shape == got.shape
    CASES[name][2](got, want)


def test_examples_import_no_jax():
    """Every example module sits beside the port's package, and the
    import check (tests/test_torch_imports.py) walks them too."""
    import pkgutil

    import oscen_tpu_torch.examples as exs
    names = {m.name for m in pkgutil.iter_modules(exs.__path__)}
    assert names == set(CASES)
