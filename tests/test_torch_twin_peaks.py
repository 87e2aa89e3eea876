"""The twin-peaks slice end to end on the CPU: ``build_twin_peaks`` through
oscen_tpu_torch against the JAX package's compiled graph, and the port's
own invariants.

Sequence (``tests/test_models_aux.py:187-199``): seeded noise (numpy,
x 0.3) fed through the ``audio_in`` stream input one block at a time;
``cutoff_a`` -> 640 and ``resonance`` -> 0.8 at block 3, ``cutoff_b`` ->
2500 at block 5.  The JAX package runs its CPU scan, or the Pallas kernel
in interpret mode with ``OSCEN_PALLAS_INTERPRET=1``.

Tolerance against JAX: 1e-6, the JAX package's own kernel-against-scan
bound (``tests/test_models_aux.py:546-548``); measured 9.8e-7 over the
2048 samples (peak 0.49).  The port's ``tanh`` is the correctly rounded
float32 value; XLA's CPU float32 ``tanh`` is up to 4 ulp from it.  Inside
the port the fused and two-node builds are bit-identical.
"""

import jax
import numpy as np
import pytest
import torch

from oscen_tpu.models import twin_peaks as jtp
from oscen_tpu_torch.models import twin_peaks as ttp
from oscen_tpu_torch.utils.convert import state_from_jax, state_to_numpy

SR = 48000.0
TOL = 1e-6
X = (np.random.default_rng(1).standard_normal(2048) * 0.3).astype(
    np.float32)


def _run(c, B=256, n=8, start=0):
    """Blocks ``start`` .. ``n-1`` of the sequence (module doc)."""
    ys = []
    for i in range(start, n):
        if i == 3:
            c.set_value("cutoff_a", 640.0)
            c.set_value("resonance", 0.8)
        if i == 5:
            c.set_value("cutoff_b", 2500.0)
        ys.append(np.asarray(c.render(
            B, stream_inputs={"audio_in": X[i * B:(i + 1) * B]}
        )["audio_out"]))
    return np.concatenate(ys)


def _port(fused, B=256):
    return ttp.build_twin_peaks(fused=fused).compile(SR, block_size=B,
                                                      device="cpu")


@pytest.mark.parametrize("interpret", [False, True],
                         ids=["jax_scan", "jax_pallas_interpret"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two_node"])
def test_twin_peaks_matches_jax(monkeypatch, fused, interpret):
    if interpret:
        monkeypatch.setenv("OSCEN_PALLAS_INTERPRET", "1")
        monkeypatch.setenv("OSCEN_UNROLL_CAP", "1")
    a = _run(jtp.build_twin_peaks(fused=fused).compile(SR, block_size=256))
    b = _run(_port(fused))
    assert b.shape == a.shape == (2048,)
    assert np.abs(a).max() > 0.3
    np.testing.assert_allclose(b, a, atol=TOL, rtol=0)


def test_twin_peaks_fused_equals_two_node():
    """Bit for bit, in the sequence and with a cutoff ramp (the per-sample
    coefficient sweep): both builds compute the same elementwise ops lane
    by lane, with a float64 tanh rounded once."""
    assert np.array_equal(_run(_port(True)), _run(_port(False)))
    outs = []
    for fused in (True, False):
        c = _port(fused, B=128)
        c.set_value_with_ramp("cutoff_b", 4000.0, 300)
        outs.append(c.render(1024, stream_inputs={"audio_in": X[:1024]})
                    ["audio_out"])
    assert np.array_equal(outs[0], outs[1])
    assert np.abs(outs[0]).max() > 0.1


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two_node"])
def test_twin_peaks_block_size_invariance(fused):
    """tests/test_models_aux.py:543-544 in the port: 512 against 128, bit
    for bit."""
    def run(B):
        c = _port(fused, B)
        return c.render(2048, stream_inputs={"audio_in": X})["audio_out"]
    np.testing.assert_array_equal(run(512), run(128))


def test_twin_peaks_band_response():
    """tests/test_models_aux.py:147-167 in the port, same thresholds: the
    band between the cutoffs passes, the lows cancel, the highs roll off
    at 18 dB/oct."""
    c = ttp.build_twin_peaks().compile(SR, block_size=512, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal(16384).astype(np.float32) * 0.3
    out = c.render_mono(16384, stream_inputs={"audio_in": x})[2048:]
    spec = np.abs(np.fft.rfft(out * np.hanning(len(out))))
    ref = np.abs(np.fft.rfft(x[2048:] * np.hanning(len(out))))
    freqs = np.fft.rfftfreq(len(out), 1 / SR)
    h = spec / np.maximum(ref, 1e-9)
    band = h[(freqs > 400) & (freqs < 2000)].mean()
    low = h[(freqs > 50) & (freqs < 300)].mean()
    high = h[(freqs > 8000) & (freqs < 16000)].mean()
    assert band > 3 * low, (band, low)
    assert band > 100 * high, (band, high)


def test_twin_peaks_kernel_noted():
    """tests/test_explain.py:178-195 in the port: the fused build notes
    ONE 2-lane lp18_scan, the two-node build two 1-lane ones."""
    c = ttp.build_twin_peaks(fused=True).compile(SR, block_size=64,
                                                 device="cpu")
    fused = [e for e in c.explain() if e.get("kernel") == "lp18_scan"]
    assert len(fused) == 1, fused
    assert fused[0]["lanes"] == 2 and fused[0]["fused_dual_filter"]
    assert fused[0]["coef_path"] == "hoisted"
    c2 = ttp.build_twin_peaks(fused=False).compile(SR, block_size=64,
                                                   device="cpu")
    two = [e for e in c2.explain() if e.get("kernel") == "lp18_scan"]
    assert len(two) == 2, two
    assert all(e["lanes"] == 1 for e in two)
    assert not any("fused_dual_filter" in e for e in two)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two_node"])
def test_twin_peaks_state_carried_from_jax(fused):
    """Three JAX blocks, the state carried into the port, the rest of the
    sequence in both: the same keys, shapes and dtypes, and the outputs
    within 1e-6."""
    jc = jtp.build_twin_peaks(fused=fused).compile(SR, block_size=256)
    tc = _port(fused)
    _run(jc, n=3)
    np_state = jax.tree_util.tree_map(np.asarray, jc.state)
    tc.state = state_from_jax(np_state, device="cpu")
    back = state_to_numpy(tc.state)
    for name in np_state:
        for k, v in np_state[name].items():
            assert back[name][k].shape == v.shape
            assert back[name][k].dtype == v.dtype
    a = _run(jc, start=3)
    b = _run(tc, start=3)
    np.testing.assert_allclose(b, a, atol=TOL, rtol=0)


def test_twin_peaks_surface_matches_jax():
    """The plugin's parameter specs and output gain; the two builds start
    from the same filter state."""
    assert ttp.OUTPUT_GAIN == jtp.OUTPUT_GAIN
    for fused in (True, False):
        js = jtp.build_twin_peaks(fused=fused).param_specs()
        ts = ttp.build_twin_peaks(fused=fused).param_specs()
        assert set(js) == set(ts) == {"cutoff_a", "cutoff_b", "resonance"}
        for k in js:
            assert (ts[k].min, ts[k].max, ts[k].log, ts[k].unit) \
                == (js[k].min, js[k].max, js[k].log, js[k].unit)
    # the initial g: numpy's float32 tan, one filter at a time in both
    f, t = _port(True).state, _port(False).state
    assert torch.equal(f["filters"]["g"], torch.stack(
        [t["filter_a"]["g"], t["filter_b"]["g"]]))
