"""The resamplers and K10 on the CPU: ``oscen_tpu_torch/ops/resample.py``
against ``oscen_tpu/ops/resample.py``, and the allpass cascade's plain
version (what ``allpass_cascade_scan`` runs on a CPU tensor, and what the
CUDA kernel of ``csrc/iir.cu`` is held to on the card) against the JAX
package's Pallas kernel in interpret mode and its ``lax.scan`` chain.

Inputs come from ``numpy.random.default_rng`` and go to both packages:
every family (latch, linear, sinc, sinc_iir) up and down at factors 2, 4
and 8, three chained blocks of ``[B, 3]`` (a trailing axis, as a node
array's instances arrive), outputs and every leaf of the carried state
compared.  The JAX package's sinc layout is forced to its CPU default, the
stage-interleaved one the port implements.

Tolerances:

- latch, linear and sinc against the JAX kernels run eagerly: bit for bit
  (the same float32 ops in the same order; measured 0);
- the same under ``jax.jit``: 1e-6 (XLA contracts the tap products and
  sums into FMAs; measured up to 4.8e-7 on inputs of unit variance);
- sinc_iir: 2e-6 either way (the JAX branch is a compiled ``lax.scan`` and
  XLA contracts ``a*(x - yp) + xp`` into an FMA; measured up to 1.2e-6);
- the plain allpass cascade against the Pallas kernel in interpret mode and
  the ``lax.scan`` chain: 2e-6 (the same contraction; measured 1.4e-6 at
  |x| <= 4, outputs up to ~5).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oscen_tpu.ops import resample as jrs
from oscen_tpu.ops.pallas.iir import allpass_cascade_scan as j_allpass
from oscen_tpu_torch.ops import resample as trs
from oscen_tpu_torch.ops.cuda import build
from oscen_tpu_torch.ops.cuda import iir as tiir
from oscen_tpu_torch.utils.convert import state_to_numpy

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ("latch", "linear", "sinc", "sinc_iir")


def _kernels(policy, n, direction):
    make = "make_upsampler" if direction == "up" else "make_downsampler"
    return getattr(jrs, make)(policy, n), getattr(trs, make)(policy, n)


def _tol(policy, jit):
    if policy == "sinc_iir":
        return 2e-6
    return 1e-6 if jit else 0.0


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("direction", ["up", "down"])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("policy", POLICIES)
def test_resampler_matches_jax(monkeypatch, policy, n, direction, jit):
    monkeypatch.delenv("OSCEN_SINC_PHASEMAJOR", raising=False)
    kj, kt = _kernels(policy, n, direction)
    like = np.zeros((1, 3), np.float32)
    sj = kj.init_state(jnp.asarray(like))
    st = kt.init_state(torch.tensor(like))
    step = jax.jit(kj.process_block) if jit else kj.process_block
    rng = np.random.default_rng(n + len(policy))
    B = 48 if direction == "up" else 48 * n
    tol = _tol(policy, jit)
    for _ in range(3):
        x = rng.standard_normal((B, 3)).astype(np.float32)
        sj, yj = step(sj, jnp.asarray(x))
        st, yt = kt.process_block(st, torch.tensor(x))
        want = B * n if direction == "up" else B // n
        assert tuple(yt.shape) == np.shape(yj) == (want, 3)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=tol,
                                   rtol=0)
        lj = jax.tree_util.tree_leaves(sj)
        lt = jax.tree_util.tree_leaves(state_to_numpy(st))
        assert (jax.tree_util.tree_structure(jax.tree_util.tree_map(
            np.asarray, sj)) == jax.tree_util.tree_structure(
            state_to_numpy(st)))
        for a, b in zip(lj, lt):
            assert np.shape(a) == b.shape
            np.testing.assert_allclose(b, np.asarray(a), atol=tol, rtol=0)
    assert float(np.abs(yt.numpy()).max()) > 0.1


def test_latency_matches_jax():
    for policy in POLICIES:
        for n in (1, 2, 4, 8):
            for direction in ("up", "down"):
                kj, kt = _kernels(policy, n, direction)
                assert kt.latency_samples() == kj.latency_samples()


# ------------------------------------------------------------------ #
# K10 allpass_cascade_scan
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("V,B", [(1, 48), (2, 64), (3, 37), (130, 40)])
def test_allpass_plain_matches_pallas_and_scan(V, B):
    """Three chained blocks, per-lane coefficients (both halfband branches'
    betas, tiled across the lanes)."""
    rng = np.random.default_rng(V + B)
    S = 2
    a = np.tile(np.array([jrs.BRANCH_A_BETAS, jrs.BRANCH_B_BETAS],
                         np.float32).T, (1, V))[:, :V].copy()
    xp = rng.uniform(-1, 1, (S, V)).astype(np.float32)
    yp = rng.uniform(-1, 1, (S, V)).astype(np.float32)
    carry_j, carry_t, carry_s = (xp, yp), (torch.tensor(xp),
                                           torch.tensor(yp)), (xp, yp)
    for _ in range(3):
        x = rng.uniform(-4, 4, (B, V)).astype(np.float32)
        yj, *carry_j = j_allpass(jnp.asarray(x), jnp.asarray(a),
                                 *map(jnp.asarray, carry_j), interpret=True)
        yt, *carry_t = tiir.allpass_cascade_scan(torch.tensor(x),
                                                 torch.tensor(a), *carry_t)
        # the JAX package's CPU path: one lax.scan per stage and lane
        ys, xs_n, ys_n = [], [], []
        for v in range(V):
            cur = jnp.asarray(x[:, v])
            for s in range(S):
                cur, y_last, x_last = jrs._allpass_block(
                    float(a[s, v]), cur, jnp.float32(carry_s[1][s, v]),
                    jnp.float32(carry_s[0][s, v]))
                xs_n.append(float(x_last))
                ys_n.append(float(y_last))
            ys.append(np.asarray(cur))
        carry_s = (np.array(xs_n, np.float32).reshape(V, S).T,
                   np.array(ys_n, np.float32).reshape(V, S).T)
        for ref in (np.asarray(yj), np.stack(ys, axis=1)):
            np.testing.assert_allclose(yt.numpy(), ref, atol=2e-6, rtol=0)
        for a_, b_ in zip(carry_t, carry_j):
            np.testing.assert_allclose(a_.numpy(), np.asarray(b_),
                                       atol=2e-6, rtol=0)
        for a_, b_ in zip(carry_t, carry_s):
            np.testing.assert_allclose(a_.numpy(), b_, atol=2e-6, rtol=0)
    assert float(yt.abs().max()) > 1.0


def test_allpass_plain_is_the_float32_recurrence():
    """The plain version is the per-sample recurrence, op for op: a float64
    emulation of separately rounded float32 ops gives the same bits."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-2, 2, (200, 2)).astype(np.float32)
    a = np.array([[0.1355741, 0.4253804], [0.6975849, 0.9055601]],
                 np.float32)
    y, xp, yp = tiir.plain_allpass_cascade_scan(
        torch.tensor(x), torch.tensor(a), torch.zeros(2, 2),
        torch.zeros(2, 2))
    f32 = np.float32
    ref = np.zeros_like(x)
    hx = np.zeros((2, 2), np.float32)
    hy = np.zeros((2, 2), np.float32)
    for t in range(200):
        cur = x[t].copy()
        for s in range(2):
            out = f32(f32(a[s] * f32(cur - hy[s])) + hx[s])
            hx[s], hy[s], cur = cur, out, out
        ref[t] = cur
    assert np.array_equal(y.numpy(), ref)
    assert np.array_equal(xp.numpy(), hx) and np.array_equal(yp.numpy(), hy)


def test_iir_halfband_roundtrip_matches_jax(monkeypatch):
    """The sinc_iir up -> down round trip of
    ``test_iir_halfband_pallas_matches_scan`` (2x, three blocks of 100):
    the port against the JAX package's scan path and its Pallas kernel in
    interpret mode (which the JAX package pins bit-equal to each other)."""
    x = np.random.default_rng(9).standard_normal(300).astype(np.float32)

    def updown(pkg, interpret=False):
        if interpret:
            monkeypatch.setenv("OSCEN_PALLAS_INTERPRET", "1")
        else:
            monkeypatch.delenv("OSCEN_PALLAS_INTERPRET", raising=False)
        up, dn = pkg.IirHalfbandUp(2), pkg.IirHalfbandDown(2)
        arr = jnp.asarray if pkg is jrs else torch.tensor
        su, sd = up.init_state(arr(np.zeros(1, np.float32))), \
            dn.init_state(arr(np.zeros(1, np.float32)))
        outs = []
        for i in range(3):
            su, hi = up.process_block(su, arr(x[i * 100:(i + 1) * 100]))
            sd, lo = dn.process_block(sd, hi)
            outs.append(np.asarray(lo))
        return np.concatenate(outs)

    port = updown(trs)
    for interpret in (False, True):
        np.testing.assert_allclose(port, updown(jrs, interpret), atol=1e-6,
                                   rtol=0)
    assert np.abs(port).max() > 0.5


def test_allpass_wrapper_rejects_what_it_does_not_take():
    x, a = torch.zeros(8, 2), torch.zeros(2, 2)
    with pytest.raises(ValueError):
        tiir.allpass_cascade_scan(x, torch.zeros(2, 3), a, a)
    with pytest.raises(ValueError):
        tiir.allpass_cascade_scan(x, torch.zeros(9, 2), torch.zeros(9, 2),
                                  torch.zeros(9, 2))
    with pytest.raises(ValueError):
        tiir.allpass_cascade_scan(x, a, torch.zeros(1, 2), a)
    before = dict(tiir.launches)
    tiir.allpass_cascade_scan(x, a, a, a)
    assert tiir.launches == before   # the plain version is not counted


def test_cuda_source_keeps_the_op_order():
    """csrc/iir.cu's allpass stage is ``a * (x - y_prev) + x_prev`` in the
    JAX package's order, built with --fmad=false, so the kernel rounds as
    the plain version's separate ops do."""
    src = (ROOT / "oscen_tpu_torch" / "csrc" / "iir.cu").read_text()
    code = re.sub(r"//.*", "", src)
    body = code[code.index("struct AllpassBody"):]
    assert "c[s] * (cur - yp[s]) + xp[s]" in body
    assert "xp[s] = cur;" in body and "yp[s] = out;" in body
    assert "--fmad=false" in build.NVCC_FLAGS
    assert not any("fast-math" in f or "ftz=true" in f
                   for f in build.NVCC_FLAGS)
