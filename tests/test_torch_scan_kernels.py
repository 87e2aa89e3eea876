"""The poly-synth slice's scan kernels on the CPU: each plain PyTorch
version (what the port's wrappers run on a CPU tensor, and what the CUDA
kernels are held to on the card) against the JAX package's Pallas kernel in
interpret mode, as ``tests/test_pallas.py`` runs it.

Inputs come from ``numpy.random.default_rng`` and go to both packages.
Shapes: V in {1, 3, 130} voice lanes (130 is past the TPU's 128-lane
padding), B in {37, 64} samples (37 is not a multiple of 8).

The Pallas kernels run with ``OSCEN_UNROLL_CAP=1``: the unroll factor sets
the size of the traced loop body, not the op order, and interpret mode
compiles an unrolled ADSR body for minutes (which is why
``test_pallas.py``'s ADSR test is in the slow tier).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oscen_tpu import AdsrEnvelope, SampleRate
from oscen_tpu.nodes.envelope import _cached_steps
from oscen_tpu.ops.pallas.adsr import adsr_scan as j_adsr_scan
from oscen_tpu.ops.pallas.iir import tpt_svf_scan as j_tpt_svf_scan
from oscen_tpu.ops.pallas.phase import phase_scan as j_phase_scan
from oscen_tpu.ops.scan import exact_wrapped_phase as j_exact_wrapped_phase
from oscen_tpu_torch.ops import scan as tscan
from oscen_tpu_torch.ops.cuda import adsr as tadsr
from oscen_tpu_torch.ops.cuda import iir as tiir
from oscen_tpu_torch.ops.cuda import phase as tphase

SHAPES = [(V, B) for V in (1, 3, 130) for B in (37, 64)]


@pytest.fixture(autouse=True)
def _no_unroll(monkeypatch):
    monkeypatch.setenv("OSCEN_UNROLL_CAP", "1")


def _t(x):
    return torch.tensor(np.asarray(x))


# ------------------------------------------------------------------ #
# K6 phase_scan
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("V,B", SHAPES)
def test_phase_scan_plain_matches_pallas(V, B):
    """Three chained blocks, bit for bit (the JAX package pins this
    kernel bit-exact against the sequential loop)."""
    rng = np.random.default_rng(V * 100 + B)
    p_j = p_t = rng.uniform(0, 1, V).astype(np.float32)
    p_t = _t(p_t)
    before = tphase.launches["phase_scan"]
    for _ in range(3):
        dt = rng.uniform(0.0, 0.3, (B, V)).astype(np.float32)
        bj, p_j = j_phase_scan(jnp.asarray(p_j), jnp.asarray(dt),
                               interpret=True)
        bt, p_t = tphase.phase_scan(p_t, _t(dt))
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
        np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    # the CPU runs the plain version, which is not a launch
    assert tphase.launches["phase_scan"] == before


def test_exact_wrapped_phase_matches_jax():
    """The port's ``ops/scan.py`` against the JAX package's (a lax.scan on
    the CPU) with trailing dims flattened into lanes, and the prefix-sum
    form against its JAX twin."""
    rng = np.random.default_rng(7)
    dt = rng.uniform(0.0, 0.2, (50, 2, 3)).astype(np.float32)
    p0 = rng.uniform(0, 1, (2, 3)).astype(np.float32)
    bj, cj = j_exact_wrapped_phase(jnp.asarray(p0), jnp.asarray(dt))
    bt, ct = tscan.exact_wrapped_phase(_t(p0), _t(dt))
    assert bt.shape == (50, 2, 3) and ct.shape == (2, 3)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    from oscen_tpu.ops.scan import wrapped_phase_cumsum as j_cumsum
    bj, cj = j_cumsum(jnp.asarray(p0), jnp.asarray(dt))
    bt, ct = tscan.wrapped_phase_cumsum(_t(p0), _t(dt))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)


# ------------------------------------------------------------------ #
# K7 tpt_svf_scan
# ------------------------------------------------------------------ #
def _tpt_coefs(rng, B, V, per_sample):
    """Coefficients of the filter's own formula at random cutoffs and Qs
    (500 Hz - 8 kHz, Q 0.5 - 1), as [V] rows or [B, V] planes."""
    shape = (B, V) if per_sample else (V,)
    f = np.tan(np.pi * rng.uniform(500, 8000, shape) / 48000.0)
    r = 1.0 / rng.uniform(0.5, 1.0, shape)
    h = 1.0 / (1.0 + r * f + f * f)
    return [np.asarray(c, np.float32) for c in (h, f, f + r)]


@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["row_coefs", "per_sample_coefs"])
@pytest.mark.parametrize("V,B", SHAPES)
def test_tpt_svf_scan_plain_matches_pallas(V, B, per_sample):
    """Three chained blocks at atol 1e-6 (the bound test_pallas.py pins:
    FMA contraction may differ between the compiled paths)."""
    rng = np.random.default_rng(V * 10 + B + per_sample)
    z_j = [jnp.zeros(V, jnp.float32)] * 2
    z_t = [torch.zeros(V)] * 2
    for _ in range(3):
        x = (0.5 * rng.standard_normal((B, V))).astype(np.float32)
        h, g, k = _tpt_coefs(rng, B, V, per_sample)
        yj, *z_j = j_tpt_svf_scan(jnp.asarray(x), jnp.asarray(h),
                                  jnp.asarray(g), jnp.asarray(k), *z_j,
                                  interpret=True)
        yt, *z_t = tiir.tpt_svf_scan(_t(x), _t(h), _t(g), _t(k), *z_t)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-6,
                                   rtol=0)
        for a, b in zip(z_t, z_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)
    assert float(np.abs(np.asarray(yj)).max()) > 0.1


def test_tpt_svf_scan_rejects_bad_shapes():
    x = torch.zeros(8, 3)
    with pytest.raises(ValueError, match="h must be"):
        tiir.tpt_svf_scan(x, torch.zeros(4), torch.zeros(3), torch.zeros(3),
                          torch.zeros(3), torch.zeros(3))
    with pytest.raises(ValueError, match="z1 must be"):
        tiir.tpt_svf_scan(x, torch.zeros(3), torch.zeros(3), torch.zeros(3),
                          torch.zeros(3), torch.zeros(8, 3))


# ------------------------------------------------------------------ #
# K11 adsr_scan
# ------------------------------------------------------------------ #
# attack, decay, sustain, release per voice (tests/test_pallas.py:274-280)
_ADSR_PARAMS = np.array([[0.0005, 0.0010, 0.60, 0.0015],
                         [0.0020, 0.0005, 0.25, 0.0008],
                         [0.0010, 0.0030, 0.90, 0.0030]], np.float32)
_ADSR_VELS = np.array([0.8, 1.0, 0.5], np.float32)
_KEYS = ("attack", "decay", "sustain", "release")


def _adsr_voices(V, rng):
    """The three parameter rows tiled across V voices, perturbed by up to
    +-10% past the first three, and their velocities."""
    reps = -(-V // 3)
    params = np.tile(_ADSR_PARAMS, (reps, 1))[:V]
    vels = np.tile(_ADSR_VELS, reps)[:V]
    if V > 3:
        params[3:] *= rng.uniform(0.9, 1.1, params[3:].shape)
        vels[3:] *= rng.uniform(0.9, 1.0, V - 3)
    return params.astype(np.float32), vels.astype(np.float32)


def _pack(st):
    return np.stack([np.asarray(st[k], np.float32) for k in
                     tadsr.STATE_ROWS])


def _gate(node, sr, st, vel, params):
    """The JAX node's own gate handler, vmapped over the voices: the state
    the kernels start a block from."""
    out = jax.vmap(lambda s, v, p: node.on_gate(s, v, sr, p))(
        {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(vel),
        {k: jnp.asarray(params[:, j]) for j, k in enumerate(_KEYS)})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("V,B", SHAPES)
def test_adsr_scan_plain_matches_pallas(V, B):
    """A full gate-on -> A/D/S -> gate-off -> R -> idle cycle in chained
    blocks of B: plain against the Pallas kernel at atol 1e-6 per block,
    levels and state."""
    rng = np.random.default_rng(V + B)
    sr = SampleRate(48000.0)
    node = AdsrEnvelope()
    params, vels = _adsr_voices(V, rng)
    pv = {k: jnp.asarray(params[:, i]) for i, k in enumerate(_KEYS)}
    rows = [np.asarray(r, np.float32) for r in _cached_steps(pv, sr.hz)]
    init = {k: np.stack([np.asarray(v)] * V)
            for k, v in node.init_state(sr).items()}
    st_on = _gate(node, sr, init, vels, params)
    sus = np.broadcast_to(params[:, 2], (B, V)).astype(np.float32)

    def run(st7, n_blocks):
        s_j = jnp.asarray(st7)
        s_t = _t(st7)
        for _ in range(n_blocks):
            yj, s_j = j_adsr_scan(s_j, *map(jnp.asarray, rows),
                                  jnp.asarray(sus), interpret=True)
            yt, s_t = tadsr.adsr_scan(s_t, *map(_t, rows), _t(sus))
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj),
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j),
                                       atol=1e-6, rtol=0)
        return np.asarray(s_j), yt.numpy()

    # 200 samples cover attack + decay into sustain for every voice
    s7, y = run(_pack(st_on), -(-200 // B))
    assert np.all(s7[0] == 3.0)                        # SUSTAIN
    np.testing.assert_allclose(y[-1], np.clip(params[:, 2] * vels, 0, 1),
                               atol=1e-6)
    # gate off: the JAX node's handler on the sustained state, as state7
    st_sus = {**init, **{k: s7[i] for i, k in enumerate(tadsr.STATE_ROWS)}}
    for k in ("stage", "rem"):
        st_sus[k] = st_sus[k].astype(np.int32)
    st_off = _gate(node, sr, st_sus, np.zeros(V, np.float32), params)
    s7, y = run(_pack(st_off), -(-180 // B))
    assert np.all(s7[0] == 0.0)                        # back to IDLE
    assert np.all(y[-1] == 0.0)
