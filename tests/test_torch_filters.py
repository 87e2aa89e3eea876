"""The filter family on the CPU: the LP18 and biquad scans (the plain
versions the port's wrappers run on a CPU tensor, and the CUDA kernels are
held to on the card) against the JAX package's Pallas kernels in
interpret mode and its per-sample tick, and the ``LP18Filter``,
``DualLP18Diff`` and ``IirLowpass`` nodes against the JAX nodes in small
graphs.

Inputs come from ``numpy.random.default_rng`` and go to both packages.
The Pallas kernels run with ``OSCEN_UNROLL_CAP=1`` (the unroll factor sets
the size of the traced loop body, not the op order).

Tolerances, and why:

- LP18 (K8): 1e-6, the JAX package's own kernel-against-scan bound
  (``tests/test_models_aux.py:546-548``).  The port's ``tanh`` is the
  correctly rounded float32 value (float64, rounded once); XLA's CPU
  float32 ``tanh`` is up to 4 ulp from it.
- biquad (K9): 1e-7 against the Pallas kernel and the JAX tick on the JAX
  package's own case (``tests/test_pallas.py:47-71``: V=2, B=48, a 2 kHz
  cutoff, zero states, far above the 1e-15 snaps).  Over chained blocks
  with random cutoffs, q and V up to 130 (outputs up to ~3): 1e-6, because
  XLA contracts the DF-II-T's products and sums into FMAs in the
  interpret-mode kernel (measured up to 8.3e-7, a few ulp); the port's
  plain scan is the float32 recurrence itself
  (``test_biquad_plain_is_the_float32_recurrence``).
- IirLowpass graphs: 2e-6.  XLA contracts the DF-II-T products and sums
  into FMAs in its compiled scan: over 2048 samples of a saw at a 1 kHz
  cutoff the JAX graph sits 5.4e-7 from the exact float32 recurrence and
  1.0e-6 from the port, whose plain scan equals a float32 numpy replay
  bit for bit (``test_biquad_plain_is_the_float32_recurrence``).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.core.types import SampleRate as JSampleRate
from oscen_tpu.nodes import filters as jfilters
from oscen_tpu.ops.pallas.iir import biquad_scan as j_biquad_scan
from oscen_tpu.ops.pallas.iir import lp18_scan as j_lp18_scan
from oscen_tpu_torch.nodes import filters as tfilters
from oscen_tpu_torch.ops.cuda import iir as tiir
from oscen_tpu_torch.utils.convert import state_to_numpy

SR = 48000.0
LP18_TOL = 1e-6
BIQUAD_TOL = 1e-7
BIQUAD_CHAIN_TOL = 1e-6
IIR_GRAPH_TOL = 2e-6
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_unroll(monkeypatch):
    monkeypatch.setenv("OSCEN_UNROLL_CAP", "1")


def _t(x):
    return torch.tensor(np.asarray(x))


def _cpu(pkg):
    """The port's graphs compile for the card unless asked for the CPU; the
    JAX package's ``compile`` takes no device."""
    return {"device": "cpu"} if pkg is T else {}


# ------------------------------------------------------------------ #
# K8 lp18_scan
# ------------------------------------------------------------------ #
def _lp18_tick_loop(z, g0, h0, x, cut, res, last_cut, last_res):
    """The JAX node's ``tick`` per lane over the block (jitted lax.scan);
    returns y ``[B, V]``, z' ``[3, V]``, the g, h each tick used and the
    first pole's state after each tick (the tanh's output)."""
    node = jfilters.LP18Filter()
    sr = JSampleRate(SR)

    def lane(z, g, h, lc, lr, xs, cs, rs):
        st = {"z": z, "g": g, "h": h, "last_cutoff": lc,
              "last_fmod": jnp.float32(0.0), "last_resonance": lr}

        def step(st, xs):
            xt, ct, rt = xs
            st, o = node.tick(st, {"input": xt, "cutoff": ct,
                                   "fmod": jnp.float32(0.0),
                                   "resonance": rt}, sr)
            return st, (o["output"], st["g"], st["h"], st["z"][0])
        st, (y, gs, hs, z0s) = jax.lax.scan(step, st, (xs, cs, rs))
        return y, st["z"], gs, hs, z0s

    run = jax.jit(jax.vmap(lane, in_axes=(1, 0, 0, 0, 0, 1, 1, 1),
                           out_axes=(1, 1, 1, 1, 1)))
    return [np.asarray(a) for a in run(z, g0, h0, last_cut, last_res, x,
                                        cut, res)]


@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["row_coefs", "per_sample_coefs"])
@pytest.mark.parametrize("V,B", [(2, 61), (3, 37)])
def test_lp18_plain_matches_pallas_and_tick(V, B, per_sample):
    """From a nonzero carried z, with inputs large enough to saturate the
    tanh: the plain scan against the Pallas kernel (interpret mode) and the
    JAX node's own tick, on the g and h that tick used (<= 1e-6)."""
    rng = np.random.default_rng(V * 100 + B + per_sample)
    z = rng.uniform(-0.8, 0.8, (3, V)).astype(np.float32)
    x = (3.0 * rng.standard_normal((B, V))).astype(np.float32)
    g0 = rng.uniform(0.05, 0.9, V).astype(np.float32)
    h0 = rng.uniform(0.0, 1.9, V).astype(np.float32)
    last_cut = rng.uniform(100, 5000, V).astype(np.float32)
    last_res = rng.uniform(0.0, 0.95, V).astype(np.float32)
    if per_sample:   # a parameter change at every sample
        cut = rng.uniform(100, 5000, (B, V)).astype(np.float32)
        res = rng.uniform(0.0, 0.99, (B, V)).astype(np.float32)
    else:            # the carried values: the tick keeps g0, h0
        cut = np.broadcast_to(last_cut, (B, V)).copy()
        res = np.broadcast_to(last_res, (B, V)).copy()
    y_tick, z_tick, gs, hs, z0s = _lp18_tick_loop(z, g0, h0, x, cut, res,
                                                  last_cut, last_res)
    g, h = (gs, hs) if per_sample else (g0, h0)
    if not per_sample:
        assert (gs == g0).all() and (hs == h0).all()
    y_t, z_t = tiir.lp18_scan(_t(x), _t(g), _t(h), _t(z))
    y_p, z_p = j_lp18_scan(jnp.asarray(x), jnp.asarray(g), jnp.asarray(h),
                           jnp.asarray(z), interpret=True)
    assert float(np.abs(z0s).max()) > 0.8   # the tanh saturates
    for ref_y, ref_z in ((y_tick, z_tick), (y_p, z_p)):
        np.testing.assert_allclose(y_t.numpy(), np.asarray(ref_y),
                                   atol=LP18_TOL, rtol=0)
        np.testing.assert_allclose(z_t.numpy(), np.asarray(ref_z),
                                   atol=LP18_TOL, rtol=0)


def test_lp18_plain_is_block_size_invariant():
    """Chained blocks of 13 and 24 samples equal one block of 37, bit for
    bit: the scan keeps the per-sample op order."""
    rng = np.random.default_rng(5)
    x = _t((1.2 * rng.standard_normal((37, 3))).astype(np.float32))
    g = _t(rng.uniform(0.05, 0.9, (37, 3)).astype(np.float32))
    h = _t(rng.uniform(0.0, 1.9, (37, 3)).astype(np.float32))
    z = torch.zeros(3, 3)
    y, zn = tiir.lp18_scan(x, g, h, z)
    y1, z1 = tiir.lp18_scan(x[:13].contiguous(), g[:13].contiguous(),
                            h[:13].contiguous(), z)
    y2, z2 = tiir.lp18_scan(x[13:].contiguous(), g[13:].contiguous(),
                            h[13:].contiguous(), z1)
    assert torch.equal(torch.cat([y1, y2]), y) and torch.equal(z2, zn)


# ------------------------------------------------------------------ #
# K9 biquad_scan
# ------------------------------------------------------------------ #
def test_biquad_plain_matches_pallas_and_tick_on_the_jax_case():
    """``tests/test_pallas.py:47-71`` in the port: IirLowpass(2000, 0.707)'s
    coefficients, V=2, B=48, from zero states, at 1e-7 against the Pallas
    kernel (interpret mode) and the JAX node's tick."""
    V, B = 2, 48
    sr = JSampleRate(SR)
    x = (np.random.default_rng(1).standard_normal((B, V)) * 0.5).astype(
        np.float32)
    f = jfilters.IirLowpass(2000.0, 0.707)
    st0 = f.init_state(sr)
    coefs = [np.float32(st0[n]) for n in ("b0", "b1", "b2", "a1", "a2")]

    def tick_lane(xs):
        def step(st, xt):
            ins = f.default_inputs()
            ins["input"] = xt
            st, o = f.tick(st, ins, sr)
            return st, o["output"]
        return jax.lax.scan(step, f.init_state(sr), xs)[1]
    y_tick = np.asarray(jax.jit(jax.vmap(tick_lane, 1, 1))(jnp.asarray(x)))
    y_p, *_ = j_biquad_scan(jnp.asarray(x),
                            *[jnp.full((V,), c) for c in coefs],
                            jnp.zeros(V), jnp.zeros(V), interpret=True)
    y_t, *_ = tiir.biquad_scan(_t(x), *[torch.full((V,), float(c))
                                        for c in coefs],
                               torch.zeros(V), torch.zeros(V))
    for ref in (y_tick, np.asarray(y_p)):
        np.testing.assert_allclose(y_t.numpy(), ref, atol=BIQUAD_TOL,
                                   rtol=0)


def _biquad_coefs(rng, shape):
    """JUCE lowpass coefficients (reference iir_lowpass/mod.rs:84-100) for
    random cutoffs and q, in float64, rounded once."""
    cut = rng.uniform(1500.0, 8000.0, shape)
    q = rng.uniform(0.5, 2.0, shape)
    n = 1.0 / np.tan(np.pi * cut / SR)
    c1 = 1.0 / (1.0 + n / q + n * n)
    return [np.asarray(c, np.float32) for c in
            (c1, 2 * c1, c1, 2 * c1 * (1 - n * n), c1 * (1 - n / q + n * n))]


@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["row_coefs", "per_sample_coefs"])
@pytest.mark.parametrize("V,B", [(1, 48), (3, 37), (130, 64)])
def test_biquad_plain_matches_pallas(V, B, per_sample):
    """Three chained blocks against the Pallas kernel (interpret mode) at
    1e-6 (see the module doc); the states stay far above 1e-15, where the
    snaps do nothing."""
    rng = np.random.default_rng(V + B + per_sample)
    v_j = [jnp.zeros(V, jnp.float32)] * 2
    v_t = [torch.zeros(V)] * 2
    for _ in range(3):
        x = (0.5 * rng.standard_normal((B, V))).astype(np.float32)
        coefs = _biquad_coefs(rng, (B, V) if per_sample else (V,))
        yj, *v_j = j_biquad_scan(jnp.asarray(x),
                                 *[jnp.asarray(c) for c in coefs], *v_j,
                                 interpret=True)
        yt, *v_t = tiir.biquad_scan(_t(x), *[_t(c) for c in coefs], *v_t)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj),
                                   atol=BIQUAD_CHAIN_TOL, rtol=0)
        for a, b in zip(v_t, v_j):
            assert float(np.abs(np.asarray(b)).min()) > 1e-12
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=BIQUAD_CHAIN_TOL, rtol=0)
    assert float(np.abs(np.asarray(yj)).max()) > 0.1


# which coefficients are per-sample planes (bit i: b0, b1, b2, a1, a2), the
# rest rows.  The Pallas kernel takes the coefficient form from b0
# (``_biquad_kernel``'s ``const_coef``) and reads a row's first line at
# every step, so b0 is a plane in each mix.
MIXED_FORMS = {"b0_only": 0b00001, "b0_b2_a2": 0b10101, "b0_b1_a1": 0b01011,
               "all_but_a2": 0b01111}


@pytest.mark.parametrize("form", MIXED_FORMS, ids=list(MIXED_FORMS))
@pytest.mark.parametrize("V,B", [(1, 48), (3, 37), (33, 64)])
def test_biquad_plain_matches_pallas_mixed_strides(V, B, form):
    """Some coefficients as ``[V]`` rows and the rest as ``[B, V]`` planes
    in one call (a time stride of 0 or V each, as the card's kernel takes
    them), three chained blocks: against the port's own call with every
    row expanded into a plane bit for bit, and against the Pallas kernel in
    interpret mode at 1e-6 times the block's peak, at least 1 (XLA's
    contracted roundings scale with the signal; these reach peaks of ~2).
    The planes are each lane's filter with every sample's coefficients
    moved by up to 1e-3 of themselves, so the filter stays stable and a
    plane read as a row moves y far above that bound."""
    mask = MIXED_FORMS[form]
    rng = np.random.default_rng(V * 7 + B + mask)
    v_j = [jnp.zeros(V, jnp.float32)] * 2
    v_t = [torch.zeros(V)] * 2
    for _ in range(3):
        x = (0.5 * rng.standard_normal((B, V))).astype(np.float32)
        rows = _biquad_coefs(rng, (V,))
        coefs = [(r * (1 + 1e-3 * rng.uniform(-1, 1, (B, V)))).astype(
            np.float32) if mask >> i & 1 else r for i, r in enumerate(rows)]
        yj, *v_j = j_biquad_scan(jnp.asarray(x),
                                 *[jnp.asarray(c) for c in coefs], *v_j,
                                 interpret=True)
        out = tiir.biquad_scan(_t(x), *[_t(c) for c in coefs], *v_t)
        full = tiir.plain_biquad_scan(
            _t(x), *[_t(np.broadcast_to(c, (B, V)).copy()) for c in coefs],
            *v_t)
        assert all(torch.equal(a, b) for a, b in zip(out, full))
        yt, *v_t = out
        tol = BIQUAD_CHAIN_TOL * max(1.0, float(np.abs(np.asarray(yj)).max()))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=tol,
                                   rtol=0)
        for a, b in zip(v_t, v_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                       rtol=0)
    assert float(np.abs(np.asarray(yj)).max()) > 0.1
    assert tiir.launches["biquad_scan"] == 0


def test_biquad_plain_is_the_float32_recurrence():
    """The plain scan equals a float32 numpy replay of the reference's
    per-sample ops bit for bit (no FMA contraction), over 2048 samples."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-0.5, 0.5, 2048).astype(np.float32)
    b0, b1, b2, a1, a2 = _biquad_coefs(rng, ())
    v1 = v2 = np.float32(0.0)
    want = np.zeros_like(x)
    for t, xt in enumerate(x):
        out = np.float32(b0 * xt) + v1
        nv1 = np.float32(np.float32(b1 * xt) - np.float32(a1 * out)) + v2
        v2 = np.float32(b2 * xt) - np.float32(a2 * out)
        v1 = nv1
        want[t] = out
    y, *_ = tiir.plain_biquad_scan(
        _t(x)[:, None],
        *[torch.tensor([float(c)]) for c in (b0, b1, b2, a1, a2)],
        torch.zeros(1), torch.zeros(1))
    np.testing.assert_array_equal(y[:, 0].numpy(), want)


def test_biquad_snaps_match_the_jax_scan():
    """An input that decays to silence: the snaps fire (|x|, |v1|, |v2|
    below 1e-15 become 0, so the tail is exactly 0), as in the JAX
    package's CPU scan, which the port's IirLowpass block is held to
    (<= 1e-7); without the snaps the tail stays tiny and nonzero."""
    B = 2048
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(B) * 0.5 * np.exp(-np.arange(B) / 20.0)
         ).astype(np.float32)
    jnode, tnode = jfilters.IirLowpass(1500.0), tfilters.IirLowpass(1500.0)
    jsr, tsr = JSampleRate(SR), T.SampleRate(SR)
    ins = {"input": x, "cutoff": np.full(B, 1500.0, np.float32),
           "q": np.full(B, np.float32(1 / np.sqrt(2)), np.float32)}
    st_j, out_j = jax.jit(
        lambda s, i: jnode.process_block(s, i, {}, jsr, B))(
            jnode.init_state(jsr), {k: jnp.asarray(v) for k, v in ins.items()})
    st_t, out_t = tnode.process_block(
        {k: v[None] for k, v in tnode.init_state(tsr).items()},
        {k: _t(v)[None] for k, v in ins.items()}, {}, tsr, B)
    y_j = np.asarray(out_j["output"])
    y_t = out_t["output"][0].numpy()
    np.testing.assert_allclose(y_t, y_j, atol=BIQUAD_TOL, rtol=0)
    assert (y_t[-200:] == 0).all() and (y_j[-200:] == 0).all()
    assert float(st_t["v1"][0]) == 0.0 == float(st_j["v1"])
    # the same recurrence without the snaps, in float32 numpy (which, like
    # the card and PyTorch's CPU, keeps denormals): its tail never reaches 0
    b0, b1, b2, a1, a2 = [np.float32(st_j[k])
                          for k in ("b0", "b1", "b2", "a1", "a2")]
    v1 = v2 = np.float32(0.0)
    tail = []
    for t, xt in enumerate(x):
        out = np.float32(b0 * xt) + v1
        v1, v2 = (np.float32(np.float32(b1 * xt) - np.float32(a1 * out))
                  + v2, np.float32(b2 * xt) - np.float32(a2 * out))
        if t >= B - 200:
            tail.append(out)
    tail = np.asarray(tail)
    assert (tail != 0).sum() > 100 and np.abs(tail).max() < 1e-15


@pytest.mark.parametrize("name,args", [
    ("lp18_scan", lambda x: (x, torch.zeros(4), torch.zeros(3),
                             torch.zeros(3, 3))),
    ("lp18_scan", lambda x: (x, torch.zeros(3), torch.zeros(3),
                             torch.zeros(2, 3))),
    ("biquad_scan", lambda x: (x, *[torch.zeros(3)] * 4, torch.zeros(8, 4),
                               torch.zeros(3), torch.zeros(3))),
    ("biquad_scan", lambda x: (x, *[torch.zeros(3)] * 5, torch.zeros(3),
                               torch.zeros(8, 3))),
])
def test_scans_reject_bad_shapes(name, args):
    with pytest.raises(ValueError, match="must be"):
        getattr(tiir, name)(*args(torch.zeros(8, 3)))


def test_iir_source_pins_the_tanh_and_the_snaps():
    """The card only equals the CPU if the kernel's tanh is the float64
    tanh rounded once (as ``ops/fmath.py::tanh``), its quotient the true
    one, and the biquad snaps at 1e-15 (as the reference tick); a float32
    ``tanhf``, a fast division or a dropped snap would show only on the
    card.  K8's short paths keep the reference beside them: a chunk whose
    rounding test left a lane undecided re-runs the reference body, with
    ``(float)tanh((double)`` and the true ``/``."""
    src = (ROOT / "oscen_tpu_torch" / "csrc" / "iir.cu").read_text()
    code = "\n".join(ln.split("//")[0] for ln in src.splitlines())
    # the reference body (the re-run) and the sweeps' yardstick
    assert code.count("(float)tanh((double)bp1)") == 1
    assert "(float)tanh((double)b)" in code
    assert "/ (1.0f + gt)" in code
    assert "if (body.undecided)" in code
    assert "tanh_exact_fast(bp1, tab, undecided)" in code
    # the short division: a float64 reciprocal refined by two Newton steps,
    # one product, one rounding; NaN (a re-run) outside [1, 4)
    assert "__double2float_rn(__dmul_rn((double)a, rd))" in code
    assert code.count("r = __fma_rn(r, __fma_rn(-dd, r, 1.0), r);") == 2
    assert "(d >= 1.0f) & (d < 4.0f) ? r :" in code
    for banned in ("tanhf", "__tanhf", "__fdividef", "__frcp_", "__expf",
                   "__drcp_rz", "use_fast_math", "tanh.approx"):
        assert banned not in code, banned
    from oscen_tpu_torch.ops.cuda import build
    assert not any("fast-math" in f or "fast_math" in f or "ftz=true" in f
                   for f in build.NVCC_FLAGS)
    # the biquad's snaps
    assert "fabsf(v) < 1e-15f ? 0.0f : v" in code
    for operand in ("snap(in[0])", "snap(c2 * xt - d2 * out)", "snap(nv1)"):
        assert operand in code, operand
    assert tiir.DENORMAL_THRESHOLD == jfilters.DENORMAL_THRESHOLD == 1e-15


# ------------------------------------------------------------------ #
# nodes in small graphs, against the JAX package
# ------------------------------------------------------------------ #
def _lp18_graph(pkg, filters, dual, count):
    g = pkg.Graph("L")
    g.input("x", "stream")
    g.input("cut", "value", default=800.0)
    g.input("res", "value", default=0.5)
    g.output("out", "stream")
    if dual:
        f = g.add("f", filters.DualLP18Diff(700.0, 2100.0, 0.6), count=count)
        g.connect("cut", f.cutoff_a)
    else:
        f = g.add("f", filters.LP18Filter(900.0, 0.3), count=count)
        g.connect("cut", f.cutoff)
    g.connect("res", f.resonance)
    g.connect("x", f.input)
    g.connect(f.output, "out")
    return g


def _lp18_run(pkg, filters, dual, count, B=64, n=8):
    """A cutoff ramp over blocks 2-3 (the per-sample coefficient sweep) and
    a resonance step at block 5, on seeded noise that saturates the
    tanh."""
    c = _lp18_graph(pkg, filters, dual, count).compile(SR, block_size=B,
                                                      **_cpu(pkg))
    x = (0.8 * np.random.default_rng(3).standard_normal(B * n)).astype(
        np.float32)
    ys = []
    for i in range(n):
        if i == 2:
            c.set_value_with_ramp("cut", 3000.0, 100)
        if i == 5:
            c.set_value("res", 0.9)
        ys.append(np.asarray(
            c.process_block(B, {"x": x[i * B:(i + 1) * B]})["out"]))
    return np.concatenate(ys), c


@pytest.mark.parametrize("count", [1, 3])
@pytest.mark.parametrize("dual", [False, True], ids=["LP18Filter",
                                                     "DualLP18Diff"])
def test_lp18_nodes_match_jax(dual, count):
    """Single nodes and node arrays of 3 (the JAX package vmaps them, the
    port runs them as lanes of one scan): the summed output within
    ``count`` x 1e-6 and every instance's state within 1e-6."""
    a, jc = _lp18_run(J, jfilters, dual, count)
    b, tc = _lp18_run(T, tfilters, dual, count)
    assert np.abs(a).max() > 0.5
    np.testing.assert_allclose(b, a, atol=count * LP18_TOL, rtol=0)
    js = jax.tree_util.tree_map(np.asarray, jc.state["f"])
    ts = state_to_numpy(tc.state["f"])
    assert set(js) == set(ts)
    for k in js:
        assert ts[k].shape == js[k].shape, k
        np.testing.assert_allclose(ts[k], js[k], atol=LP18_TOL, rtol=0,
                                   err_msg=k)


def test_lp18_coefficient_path_follows_const_ins():
    """Hoisted rows while every parameter is block-constant, the
    per-sample sweep while the cutoff ramps; the same numbers either way
    (the fused node is held to the two-node build in
    test_torch_twin_peaks.py)."""
    c = _lp18_graph(T, tfilters, False, 1).compile(SR, block_size=64,
                                                   device="cpu")
    assert {"node": "f", "kernel": "lp18_scan", "lanes": 1,
            "coef_path": "hoisted", "sequential_exact": True} in c.explain()
    c.set_value_with_ramp("cut", 3000.0, 100)
    notes = [e for e in c.explain() if e.get("kernel") == "lp18_scan"]
    assert notes[0]["coef_path"] == "sweep"


def _iir_graph(pkg, count=1):
    """``tests/test_block_invariance.py:79-90`` with the cutoff as a graph
    parameter: saw(330, 0.5) -> IirLowpass(1000) -> out."""
    g = pkg.Graph("I")
    g.input("cutoff", "value", default=1000.0)
    g.output("out", "stream")
    o = g.add("o", pkg.Oscillator.saw(330.0, 0.5), count=count)
    f = g.add("f", pkg.IirLowpass(1000.0), count=count)
    g.connect("cutoff", f.cutoff)
    g.connect(o.output, f.input)
    g.connect(f.output, "out")
    return g


def _iir_run(pkg, B, count=1, total=2048, change_at=None):
    c = _iir_graph(pkg, count).compile(SR, block_size=B, **_cpu(pkg))
    out, pos = [], 0
    while pos < total:
        if change_at is not None and pos >= change_at:
            c.set_value("cutoff", 2500.0)
            change_at = None
        n = min(B, total - pos)
        out.append(np.asarray(c.render(n)["out"]))
        pos += n
    return np.concatenate(out), c


@pytest.mark.parametrize("count", [1, 3])
@pytest.mark.parametrize("B", [512, 48, 33])
def test_iir_lowpass_matches_jax(B, count):
    """The mod-32 cadence across block edges (48 and 33 are not multiples
    of 32) and a cutoff change mid-run; output and state against the JAX
    package (see the module doc for the bound)."""
    a, jc = _iir_run(J, B, count, change_at=700)
    b, tc = _iir_run(T, B, count, change_at=700)
    assert np.abs(a).max() > 0.3 * count
    np.testing.assert_allclose(b, a, atol=count * IIR_GRAPH_TOL, rtol=0)
    js = jax.tree_util.tree_map(np.asarray, jc.state["f"])
    ts = state_to_numpy(tc.state["f"])
    np.testing.assert_array_equal(ts["frame_counter"], js["frame_counter"])
    assert ts["frame_counter"].dtype == np.int32
    for k in ("b0", "b1", "b2", "a1", "a2", "v1", "v2"):
        np.testing.assert_allclose(ts[k], js[k], atol=IIR_GRAPH_TOL, rtol=0,
                                   err_msg=k)


def test_iir_lowpass_block_size_invariance():
    """tests/test_block_invariance.py:79-90 in the port: 512, 48 and 33
    bit for bit."""
    ref, _ = _iir_run(T, 512)
    for B in (48, 33):
        np.testing.assert_array_equal(_iir_run(T, B)[0], ref)


def test_iir_lowpass_latches_at_update_frames():
    """Before a block's first update frame the carried coefficients hold,
    from it on the new ones: a cutoff change after 40 samples (counter 8)
    reaches the filter 24 samples later, at the next multiple of 32."""
    c = _iir_graph(T).compile(SR, block_size=40, device="cpu")
    c.process_block()
    old = {k: c.state["f"][k].clone() for k in ("b0", "a1")}
    c.set_value("cutoff", 4000.0)
    c.process_block(20)          # counter 8 -> 28: no update frame yet
    assert all(torch.equal(c.state["f"][k], old[k]) for k in old)
    c.process_block(10)          # crosses frame 32: the new coefficients
    assert not torch.equal(c.state["f"]["b0"], old["b0"])
    assert int(c.state["f"]["frame_counter"]) == (40 + 30) % 32
    assert {"node": "f", "kernel": "biquad_scan", "lanes": 1,
            "sequential_exact": True} in c.explain()
