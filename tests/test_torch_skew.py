"""The skewed schedules of K10 (``csrc/iir.cu``'s ``allpass_kernel``) and
of K13 / K15 (``csrc/fm.cu``'s ``chain3_kernel``), modelled in plain
PyTorch on the CPU.

Each model runs its kernel's schedule in its order.  K10 runs its stages a
sample apart: the pipeline's fill (stages without a sample yet idle), the
steady body, and the drain after the last input (stages whose samples are
done idle), each stage reading its predecessor's output of the iteration
before; y is staged per 32-step chunk at the iteration's step and written
back ``S - 1`` rows earlier, as the producer does (the drain's outputs go
straight to y), so a wrong shift leaves a NaN or a misplaced row.  The
chains run each operator on its own warp, a 32-sample chunk apart: at step
s op3 runs chunk s, op2 chunk s - 1 and op1 chunk s - 2, the route between
them passing through buffers double-buffered by chunk (NaN until written,
so a wrong buffer or skew shows).

Each is held bit for bit (``torch.equal``) to the plain version, which
``tests/test_torch_resample.py`` and ``tests/test_torch_fm_kernels.py`` hold
to the JAX package's Pallas kernels, over three chained blocks (so a wrong
final carry shows), for blocks shorter than the skew, at the ring's chunk
edges and at the main paths' length.  The card runs the kernels themselves
against the plain versions (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from oscen_tpu_torch.ops.fastmath import sin_turns, sin_turns_fma
from oscen_tpu_torch.ops.fmath import fma
from oscen_tpu_torch.ops.cuda import fm as tfm
from oscen_tpu_torch.ops.cuda import iir as tiir

CHUNK = 32   # steps per ring chunk (scan_stage.cuh's kChunk)


def skewed_allpass(x, a, xp, yp, chunk=CHUNK):
    """``allpass_kernel``'s schedule: iteration k runs stage s on sample
    k - s, the last stage first (each reads its predecessor's output of the
    iteration before); y staged per chunk and written back S - 1 rows
    earlier; the drain's outputs stored directly."""
    B, V = x.shape
    S = a.shape[0]
    c = list(a.unbind(0))
    xps, yps = list(xp.unbind(0)), list(yp.unbind(0))
    y = torch.full_like(x, float("nan"))

    def stage(s, inp):
        out = c[s] * (inp - yps[s]) + xps[s]
        xps[s], yps[s] = inp, out

    for c0 in range(0, B, chunk):
        n = min(chunk, B - c0)
        slot = torch.full((n, V), float("nan"))
        for t in range(n):
            k = c0 + t
            fill = k < S - 1
            for s in range(S - 1, 0, -1):
                if not fill or s <= k:
                    stage(s, yps[s - 1])
            stage(0, x[k])
            if not fill:
                slot[t] = yps[S - 1]
        for t in range(n):   # the producer's write-back
            if c0 + t >= S - 1:
                y[c0 + t - (S - 1)] = slot[t]
    for j in range(S - 1):   # the drain: iteration B + j
        for s in range(S - 1, 0, -1):
            if j < s <= B + j:
                stage(s, yps[s - 1])
        if S - 1 <= B + j:
            y[B + j - (S - 1)] = yps[S - 1]
    return y, torch.stack(xps), torch.stack(yps)


def _wrap(p):
    return p - torch.trunc(p)


def skewed_chain3(pivot, phases, prevs, dt, fb, mix, e3, e2, e1, inv_sr,
                  chunk=CHUNK):
    """``chain3_kernel``'s schedule on level-folded envelopes: at step s the
    warp of op3 runs chunk s, op2's chunk s - 1, op1's chunk s - 2; op3's
    route (the fm chain's a and b; the pivot's enveloped output a3, from
    which op2 forms the route inside its fused multiply-adds) and op2's
    modulation of op1 (pm1) pass through buffers double-buffered by chunk.
    Within a step the model runs op3, op2, op1 one after the other (the
    warps run at once on disjoint buffers).  Each phase steps by
    ``fma(dt, inv_sr, p)``."""
    B, V = e3.shape
    per_sample = dt.shape[1] == B and B > 1
    chunks = -(-B // chunk)
    y = torch.full_like(e3, float("nan"))
    route = {k: torch.full((2, chunk, V), float("nan"))
             for k in ("a", "b", "pm1")}
    ph, prev = list(phases.unbind(0)), list(prevs.unbind(0))
    om = 1.0 - mix
    env = (e3, e2, e1)
    sine = sin_turns_fma if pivot else sin_turns
    madd = fma if pivot else (lambda a, b, c: c + a * b)

    def run(r, k):   # operator r (0: op3, 1: op2, 2: op1) over chunk k
        for t in range(min(chunk, B - k * chunk)):
            i = k * chunk + t
            if r == 0:
                s_ = sine(madd(prev[0], fb[0], ph[0]))
                out = s_ * env[0][i]
                if pivot:
                    route["a"][k % 2, t] = out
                else:
                    route["a"][k % 2, t] = out * om
                    route["b"][k % 2, t] = out * mix
            elif r == 1 and pivot:
                a3 = route["a"][k % 2, t]
                s_ = sine(fma(prev[1], fb[1], fma(a3, om, ph[1])))
                out = s_ * env[1][i]
                route["pm1"][k % 2, t] = fma(a3, mix, out)
            elif r == 1:
                s_ = sine((ph[1] + route["a"][k % 2, t]) + prev[1] * fb[1])
                out = s_ * env[1][i]
                route["pm1"][k % 2, t] = out + route["b"][k % 2, t]
            else:
                s_ = sine(madd(prev[2], fb[2],
                               ph[2] + route["pm1"][k % 2, t]))
                out = s_ * env[2][i]
                y[i] = out
            prev[r] = s_ if pivot else out
            q = fma(dt[r, i] if per_sample else dt[r, 0], inv_sr, ph[r])
            ph[r] = _wrap(q)

    for s in range(chunks + 2):
        for r in range(3):
            if 0 <= s - r < chunks:
                run(r, s - r)
    return y, torch.stack(ph), torch.stack(prev)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _same(a, b):
    return all(torch.equal(u, w) for u, w in zip(a, b))


# blocks shorter than every skew, around the ring's chunk, the main path's
ALLPASS_B = (1, 2, 3, 7, 8, 9, CHUNK - 1, CHUNK, CHUNK + 1, 1024)


@pytest.mark.parametrize("B", ALLPASS_B)
@pytest.mark.parametrize("S", range(1, 9))
def test_skewed_allpass_equals_plain(S, B):
    """Three chained blocks at V = 1, 2, 3 and 33 (betas per lane), every
    output and carry bit for bit."""
    for V in (1, 2, 3, 33):
        rng = np.random.default_rng(100 * S + B + V)
        a = _t(rng.uniform(-0.95, 0.95, (S, V)))
        carry = (_t(rng.uniform(-1, 1, (S, V))), _t(rng.uniform(-1, 1, (S, V))))
        for _ in range(3):
            x = _t(rng.standard_normal((B, V)))
            got = skewed_allpass(x, a, *carry)
            want = tiir.plain_allpass_cascade_scan(x, a, *carry)
            assert _same(got, want), (S, B, V)
            carry = got[1:]


def _chain_block(rng, V, B, per_sample):
    """One block's operands: ``base_freq*ratio`` per sample (the pitch
    steps a third of the way in, as at a note-on) or as rows; feedback on
    all three operators."""
    freq = np.broadcast_to(rng.uniform(100, 1000, V), (B, V)).copy()
    if per_sample:
        freq[B // 3:, ::2] *= 1.5
    dt = np.stack([freq * r for r in (3.0, 2.0, 1.0)])
    if not per_sample:
        dt = dt[:, :1]
    return (_t(dt), _t(rng.uniform(0.3, 1.0, (3, V))),
            _t(rng.uniform(0.2, 0.6, (3, V))), _t(rng.uniform(0, 1, V)),
            *[_t(rng.uniform(0.1, 1.0, (B, V))) for _ in range(3)])


@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["dt_rows", "dt_per_sample"])
@pytest.mark.parametrize("B", (1, 2, 3, 33, 1024))
@pytest.mark.parametrize("chain", ["fm", "pivot"])
def test_skewed_chain_equals_plain(chain, B, per_sample):
    """Three chained blocks at V = 3, every output and carry bit for bit,
    with feedback on every operator, the phases stepping by
    ``fma(base_freq*ratio, 1/sr, p)``."""
    pivot = chain == "pivot"
    plain = getattr(tfm, f"plain_{chain}_chain3_scan")
    V = 3
    inv = float(np.float32(1) / np.float32(48000))
    rng = np.random.default_rng(B + 7 * per_sample + pivot)
    carry = (_t(rng.uniform(0, 1, (3, V))), _t(rng.normal(size=(3, V))))
    for _ in range(3):
        dt, lvl, fb, mix, *env = _chain_block(rng, V, B, per_sample)
        assert bool((fb > 0).all())
        folded = tfm._fold_levels(lvl, *env)
        got = skewed_chain3(pivot, *carry, dt, fb, mix, *folded, inv)
        want = plain(*carry, dt, lvl, fb, mix, *env, inv_sr=inv)
        assert _same(got, want)
        carry = got[1:]
