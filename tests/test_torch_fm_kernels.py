"""The FM slice's kernels on the CPU: each plain PyTorch version (what the
port's wrappers run on a CPU tensor, and what the CUDA kernels of
``csrc/fm.cu`` are held to on the card) against the JAX package's Pallas
kernel in interpret mode, as ``tests/test_pallas.py`` runs it, and the
port's zero-feedback branch against its sequential chain.

Inputs come from ``numpy.random.default_rng`` and go to both packages.
Shapes: V in {1, 3, 130} voice lanes (130 is past the TPU's 128-lane
padding), B in {62, 64} samples (62 is not a multiple of 8), two chained
blocks.  The Pallas kernels run with ``OSCEN_UNROLL_CAP=1`` (the unroll
factor sets the size of the traced loop body, not the op order).

Tolerances: ``fract_phase3`` bit for bit (the JAX package pins it so);
the fm chain and the operator 1e-6 (``test_pallas.py:126,178``: XLA may
contract a product and a sum into an FMA inside the Pallas kernel); the
pivot chain 1e-5 (``test_pivot.py:202``: its raw-sine feedback amplifies
those 1-ulp seeds), for one block from zero carries at V <= 3 as the JAX
tests run it; from a carry, or at V=130, the Pallas kernel's own drift
from its tick (``_bound``); the JAX zero-feedback branch: phases bit for bit, the rest
1e-5 (``test_pallas.py:215-221``).  The fm chain's and the operator's
plain versions also equal the JAX node's eager per-sample ``tick`` bit for
bit; the pivot chain's, given ``base_freq*ratio`` and the float32
reciprocal of the rate, equals the JAX pivot ``tick`` as XLA compiles it
in a graph (a jitted scan, whose products into sums are fused
multiply-adds) bit for bit.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oscen_tpu.ops import fastmath as jfast
from oscen_tpu.ops.pallas import fm as jfm
from oscen_tpu_torch.ops import fastmath as tfast
from oscen_tpu_torch.ops.cuda import fm as tfm

SHAPES = [(1, 64), (3, 62), (130, 64)]
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_unroll(monkeypatch):
    monkeypatch.setenv("OSCEN_UNROLL_CAP", "1")


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ #
# the operator sine
# ------------------------------------------------------------------ #
def test_sin_turns_matches_jax_bit_for_bit():
    """Random arguments over several turns plus exact halves, where a
    round-half-away-from-zero would pick the other integer and flip the
    sign of the result."""
    rng = np.random.default_rng(0)
    halves = np.arange(-6, 6, dtype=np.float32) + np.float32(0.5)
    x = np.concatenate([rng.uniform(-4, 4, 4000).astype(np.float32), halves,
                        np.float32([0.0, 0.25, -0.25, 1e-30, 3.0])])
    a = np.asarray(jfast.sin_turns(jnp.asarray(x)))
    b = tfast.sin_turns(_t(x)).numpy()
    np.testing.assert_array_equal(b, a)
    assert np.abs(b - np.sin(2 * np.pi * x.astype(np.float64))).max() < 2e-5
    # round half to even: 0.5 -> 0, so w = +0.5 (half away: w = -0.5)
    w = halves - torch.round(_t(halves)).numpy()
    assert np.all(np.abs(w) == 0.5) and len(set(np.sign(w))) == 2


def test_cuda_source_uses_the_same_sine_and_wrap():
    """csrc/fm.cu holds the float32 coefficients as hex literals equal to
    the port's, rounds half to even (rintf, not roundf) and wraps with
    truncf (Rust .fract()), not floorf."""
    src = (ROOT / "oscen_tpu_torch" / "csrc" / "fm.cu").read_text()
    lits = re.findall(r"constexpr float kC(\d) = (-?0x[0-9a-fp.+-]+)f;", src)
    coeffs = {int(i): float.fromhex(h) for i, h in lits}
    assert coeffs == dict(enumerate(tfast.SIN_TURNS_F32))
    assert tfast.SIN_TURNS_F32 == tuple(
        float(np.float32(c)) for c in jfast.SIN_TURNS_COEFFS)
    code = re.sub(r"//.*", "", src)
    assert "rintf(" in code and "roundf(" not in code
    assert "truncf(" in code and "floorf(" not in code


# ------------------------------------------------------------------ #
# K12 fract_phase3
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("V,B", SHAPES)
def test_fract_phase3_plain_matches_pallas(V, B):
    rng = np.random.default_rng(V * 100 + B)
    p_j = rng.uniform(-1, 1, (3, V)).astype(np.float32)
    p_t = _t(p_j)
    for _ in range(2):
        dt = rng.uniform(-0.05, 0.4, (3, V)).astype(np.float32)
        oj = jfm.fract_phase3(jnp.asarray(p_j), jnp.asarray(dt), B,
                              interpret=True)
        ot = tfm.fract_phase3(p_t, _t(dt), B)
        for a, b in zip(oj, ot):
            assert torch.equal(b, _t(a))
        p_j, p_t = oj[3], ot[3]
    assert tfm.launches["fract_phase3"] == 0


# ------------------------------------------------------------------ #
# K13 / K15 the chains, K14 the operator
# ------------------------------------------------------------------ #
def _bound(name, V, first):
    """The JAX package pins 1e-6 (fm chain, operator) and 1e-5 (pivot)
    for one block from zero carries at its own tests' widths (V=2).  From
    a nonzero carry, or at V=130, its Pallas kernel drifts further from
    its own tick (measured with these inputs on the CPU: up to 3.7e-6 fm
    chain, 1.8e-5 pivot: XLA contracts products and sums into FMAs inside the kernel and
    the feedback amplifies them), while the port equals the tick bit for
    bit (asserted beside it), so the bound there is that drift with
    headroom."""
    if first and V <= 3:
        return 1e-5 if name == "pivot" else 1e-6
    return 3e-5 if name == "pivot" else 5e-6


def _three(V, a, b, c):
    return np.broadcast_to(np.float32([a, b, c])[:, None], (3, V)).copy()


def _chain_block(rng, V, B, per_sample):
    """The JAX tests' settings: feedback (0.3, 0.1, 0.0), levels
    (0.5, 0.5, 1.0), route 0.4, envelopes in [0.2, 1]; a per-sample pitch
    steps mid-block like a note-on.  Returns the base frequency ``[B, V]``
    and the kernel's arguments after the carries."""
    freq = np.full((B, V), 220.0, np.float32)
    if per_sample:
        freq[B // 3:, ::2] = 330.0
    # the tick's eager f*ratio/sr: a correctly rounded float32 quotient
    dt = np.stack([(freq * np.float32(r)) / np.float32(48000.0)
                   for r in (3.0, 2.0, 1.0)]).astype(np.float32)
    if not per_sample:
        dt = dt[:, :1]
    envs = [rng.uniform(0.2, 1.0, (B, V)).astype(np.float32)
            for _ in range(3)]
    return freq, (dt, _three(V, 0.5, 0.5, 1.0), _three(V, 0.3, 0.1, 0.0),
                  np.full((V,), 0.4, np.float32), *envs)


def _chain_tick(chain, st, freq, args):
    """The JAX node's own per-sample tick over all V lanes at once: the fm
    chain's eagerly (one XLA call per op, nothing contracted), the pivot's
    as a ``CompiledGraph`` runs it (a jitted scan, every input a runtime
    operand, ``vmap`` over the lanes), where XLA contracts its products
    into sums."""
    import jax
    from oscen_tpu.core.types import SampleRate
    from oscen_tpu.models.fm_synth import FmOperatorChain
    from oscen_tpu.models.pivot import PivotOperatorChain
    node = FmOperatorChain() if chain == "fm" else PivotOperatorChain()
    _, lvl, fb, mix, e3, e2, e1 = args
    prm = {f"op{i}_ratio": np.float32(r) for i, r in ((3, 3), (2, 2),
                                                      (1, 1))}
    for r, i in enumerate((3, 2, 1)):
        prm[f"op{i}_level"] = lvl[r, 0]
        prm[f"op{i}_feedback"] = fb[r, 0]
    prm["route"] = mix[0]
    if chain == "fm":
        ins = {k: jnp.float32(v) for k, v in prm.items()}
        st = {k: jnp.asarray(v) for k, v in st.items()}
        ys = []
        for t in range(freq.shape[0]):
            ins.update(base_freq=jnp.asarray(freq[t]),
                       env3=jnp.asarray(e3[t]), env2=jnp.asarray(e2[t]),
                       env1=jnp.asarray(e1[t]))
            st, o = node.tick(st, ins, SampleRate(48000.0))
            ys.append(np.asarray(o["output"]))
        return np.stack(ys), np.asarray(st["phases"]), np.asarray(st["prevs"])
    B = freq.shape[0]
    prm = {k: np.full((B,), v, np.float32) for k, v in prm.items()}
    lanes = ("base_freq", "env3", "env2", "env1")
    tick = jax.vmap(lambda s, i: node.tick(s, i, SampleRate(48000.0)),
                    in_axes=(0, {k: 0 if k in lanes else None
                                 for k in (*prm, *lanes)}))

    def body(s, xs):
        s, o = tick(s, xs)
        return s, o["output"]

    st = {k: jnp.asarray(np.ascontiguousarray(v.T)) for k, v in st.items()}
    xs = {**{k: jnp.asarray(v) for k, v in prm.items()},
          "base_freq": jnp.asarray(freq), "env3": jnp.asarray(e3),
          "env2": jnp.asarray(e2), "env1": jnp.asarray(e1)}
    st, ys = jax.jit(lambda s, x: jax.lax.scan(body, s, x))(st, xs)
    return (np.asarray(ys), np.asarray(st["phases"]).T,
            np.asarray(st["prevs"]).T)


def _fr(freq, per_sample):
    """``base_freq*ratio`` per operator, ``[3, B, V]`` or ``[3, 1, V]``."""
    fr = np.stack([freq * np.float32(r) for r in (3.0, 2.0, 1.0)])
    return fr if per_sample else fr[:, :1]


@pytest.mark.parametrize("per_sample", [True, False],
                         ids=["per_sample_dt", "const_dt"])
@pytest.mark.parametrize("V,B", SHAPES)
@pytest.mark.parametrize("chain", ["fm", "pivot"])
def test_chain_plain_matches_pallas_and_tick(chain, V, B, per_sample):
    """Two chained blocks.  Against the Pallas kernel both packages start
    each block from the same carry (the bound is a one-block bound, the
    feedback amplifies the kernel's FMA seeds across blocks); against the
    JAX tick (the pivot's as XLA compiles it) the port runs on its own
    carry, bit for bit."""
    jscan = getattr(jfm, f"_{chain}_chain3_pallas")
    tscan = getattr(tfm, f"{chain}_chain3_scan")
    rng = np.random.default_rng(V * 7 + B + per_sample)
    carry = (np.zeros((3, V), np.float32),) * 2
    own = tuple(map(_t, carry))
    for blk in range(2):
        atol = _bound(chain, V, blk == 0)
        freq, args = _chain_block(rng, V, B, per_sample)
        yj, ph_j, pv_j = jscan(*map(jnp.asarray, carry + args),
                               interpret=True)
        yt, ph_t, pv_t = tscan(*map(_t, carry + args))
        # the phase recurrence has no feedback in it: bit for bit
        np.testing.assert_array_equal(ph_t.numpy(), np.asarray(ph_j))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=atol,
                                   rtol=0)
        # the carried feedback is the LAST real sample's
        np.testing.assert_allclose(pv_t.numpy(), np.asarray(pv_j),
                                   atol=atol, rtol=0)
        ys, ph_k, pv_k = _chain_tick(
            chain, {"phases": own[0].numpy(), "prevs": own[1].numpy()},
            freq, args)
        if chain == "fm":
            yo, *own = tscan(*own, *map(_t, args))
        else:
            yo, *own = tscan(*own, _t(_fr(freq, per_sample)),
                             *map(_t, args[1:]),
                             inv_sr=float(np.float32(1) / np.float32(48000)))
        assert torch.equal(yo, _t(ys))
        assert torch.equal(own[0], _t(ph_k))
        assert torch.equal(own[1], _t(pv_k))
        own = tuple(own)
        carry = (np.asarray(ph_j), np.asarray(pv_j))
    assert np.abs(np.asarray(yj)).max() > 0.05
    assert tfm.launches[f"{chain}_chain3_scan"] == 0


@pytest.mark.parametrize("V,B", SHAPES)
def test_fm_operator_plain_matches_pallas_and_tick(V, B):
    """Per-sample pitch, phase modulation, feedback 0.4, envelope and
    level (tests/test_pallas.py:95-128), two chained blocks, as the chain
    test: the Pallas kernel from a shared carry, the tick bit for bit."""
    from oscen_tpu import FmOperator, SampleRate
    node = FmOperator()
    rng = np.random.default_rng(V + B)
    carry = (np.zeros(V, np.float32),) * 2
    own = tuple(map(_t, carry))
    for blk in range(2):
        atol = _bound("operator", V, blk == 0)
        freq = rng.uniform(100, 1400, (B, V)).astype(np.float32)
        pm, env, lvl = (rng.uniform(-0.2, 0.2, (B, V)),
                        rng.uniform(0.2, 1.0, (B, V)),
                        rng.uniform(0.5, 1.0, (B, V)))
        planes = [(freq * np.float32(2.0)) / np.float32(48000.0), pm,
                  np.full((B, V), 0.4), env, lvl]
        planes = [np.asarray(p, np.float32) for p in planes]
        yj, ph_j, pv_j = jfm.fm_operator_scan(
            *map(jnp.asarray, carry + tuple(planes)), interpret=True)
        yt, ph_t, pv_t = tfm.fm_operator_scan(*map(_t, carry),
                                              *map(_t, planes))
        np.testing.assert_array_equal(ph_t.numpy(), np.asarray(ph_j))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj),
                                   atol=atol, rtol=0)
        np.testing.assert_allclose(pv_t.numpy(), np.asarray(pv_j),
                                   atol=atol, rtol=0)
        np.testing.assert_array_equal(pv_t.numpy(), yt.numpy()[-1])
        # the tick, eagerly over the V lanes
        st = {"phase": jnp.asarray(own[0].numpy()),
              "prev_output": jnp.asarray(own[1].numpy())}
        ys = []
        for t in range(B):
            st, o = node.tick(st, dict(
                base_freq=jnp.asarray(freq[t]), ratio=jnp.float32(2.0),
                phase_mod=jnp.asarray(planes[1][t]),
                feedback=jnp.asarray(planes[2][t]),
                envelope=jnp.asarray(planes[3][t]),
                level=jnp.asarray(planes[4][t])), SampleRate(48000.0))
            ys.append(np.asarray(o["output"]))
        yo, *own = tfm.fm_operator_scan(*own, *map(_t, planes))
        assert torch.equal(yo, _t(np.stack(ys)))
        assert torch.equal(own[0], _t(st["phase"]))
        own = tuple(own)
        carry = (np.asarray(ph_j), np.asarray(pv_j))
    assert tfm.launches["fm_operator_scan"] == 0


# ------------------------------------------------------------------ #
# the zero-feedback branch
# ------------------------------------------------------------------ #
def _fast_inputs(rng, V):
    """tests/test_pallas.py:193-201: random phases, prevs, route and
    block-constant dt."""
    return dict(
        ph=rng.uniform(0, 1, (3, V)).astype(np.float32),
        pv=rng.normal(size=(3, V)).astype(np.float32),
        dt=rng.uniform(0.001, 0.4, (3, 1, V)).astype(np.float32),
        lvl=np.broadcast_to(np.float32([0.5, 0.7, 1.0])[:, None],
                            (3, V)).copy(),
        mix=rng.uniform(0, 1, (V,)).astype(np.float32))


@pytest.mark.parametrize("chain", ["fm", "pivot"])
def test_fast_branch_matches_jax(chain):
    """The port's zero-feedback branch against the JAX package's
    (fract_phase3 in interpret mode plus jnp), two chained blocks."""
    jscan = getattr(jfm, f"{chain}_chain3_scan")
    tscan = getattr(tfm, f"{chain}_chain3_scan")
    V, B = 4, 64
    rng = np.random.default_rng(3)
    x = _fast_inputs(rng, V)
    fb = np.zeros((3, V), np.float32)
    ph_j, pv_j = x["ph"], x["pv"]
    ph_t, pv_t = _t(ph_j), _t(pv_j)
    for _ in range(2):
        envs = [rng.uniform(0.1, 1, (B, V)).astype(np.float32)
                for _ in range(3)]
        args = (x["dt"], x["lvl"], fb, x["mix"], *envs)
        yj, ph_j, pv_j = jscan(jnp.asarray(ph_j), jnp.asarray(pv_j),
                               *map(jnp.asarray, args), interpret=True,
                               fb_static=True)
        yt, ph_t, pv_t = tscan(ph_t, pv_t, *map(_t, args), fb_zero=True)
        np.testing.assert_array_equal(ph_t.numpy(), np.asarray(ph_j))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(pv_t.numpy(), np.asarray(pv_j),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("V", [1, 5, 130])
@pytest.mark.parametrize("chain", ["fm", "pivot"])
def test_fast_branch_equals_sequential_chain(chain, V):
    """With every feedback 0 the fast branch and the sequential chain are
    bit-equal, output and state, over 3 chained blocks: the branch choice
    never changes the numbers."""
    tscan = getattr(tfm, f"{chain}_chain3_scan")
    plain = getattr(tfm, f"plain_{chain}_chain3_scan")
    B = 64
    rng = np.random.default_rng(V)
    x = {k: _t(v) for k, v in _fast_inputs(rng, V).items()}
    fb = torch.zeros(3, V)
    fast = (x["ph"], x["pv"])
    seq = fast
    for _ in range(3):
        envs = [_t(rng.uniform(0.1, 1, (B, V)).astype(np.float32))
                for _ in range(3)]
        args = (x["dt"], x["lvl"], fb, x["mix"], *envs)
        out_f = tscan(*fast, *args, fb_zero=True)
        out_s = plain(*seq, *args)
        for a, b in zip(out_f, out_s):
            assert torch.equal(a, b)
        # not eligible (B % 8 != 0): the sequential chain runs
        assert all(torch.equal(a, b) for a, b in zip(
            tscan(*fast, x["dt"], x["lvl"], fb, x["mix"],
                  *[e[:61] for e in envs], fb_zero=True),
            plain(*fast, x["dt"], x["lvl"], fb, x["mix"],
                  *[e[:61] for e in envs])))
        fast, seq = out_f[1:], out_s[1:]
    assert float(out_f[0].abs().max()) > 0.05


def test_wrappers_reject_bad_shapes():
    z3, env = torch.zeros(3, 4), torch.zeros(16, 4)
    with pytest.raises(ValueError, match="dt must be"):
        tfm.fm_chain3_scan(z3, z3, torch.zeros(3, 8, 4), z3, z3,
                           torch.zeros(4), env, env, env)
    with pytest.raises(ValueError, match="mix must be"):
        tfm.pivot_chain3_scan(z3, z3, torch.zeros(3, 1, 4), z3, z3,
                              torch.zeros(3), env, env, env)
    with pytest.raises(ValueError, match="phases and dt"):
        tfm.fract_phase3(torch.zeros(2, 4), torch.zeros(2, 4), 8)
    with pytest.raises(ValueError, match="prev0 must be"):
        tfm.fm_operator_scan(torch.zeros(4), torch.zeros(3), env, env, env,
                             env, env)
    with pytest.raises(ValueError, match="no fm_operator_scan kernel"):
        m = torch.zeros(16, 4, device="meta")
        tfm.fm_operator_scan(torch.zeros(4, device="meta"),
                             torch.zeros(4, device="meta"), m, m, m, m, m)
