"""K11's schedule (``csrc/adsr.cu``'s ``adsr_kernel``), modelled in plain
PyTorch on the CPU.

The model runs the kernel's order per group of 32 voices: the warp's test
that every voice holds (SUSTAIN or IDLE) on the input state, which sends
every time slice of 256 rows to the time-parallel pass; otherwise the serial
part in 32-step chunks: a chunk the warp's count of event-free groups of 8
steps covers runs whole in the fast body (no stage change in any voice:
``AdsLane::fast`` in its four forms by the stages present, a release's
level unclipped and its quotient undivided by the select the full step
makes), any other by groups of 8, the fast body while the count lasts and
the warp holds no release, else the full step and a recount; the steps
after a ragged chunk's last full group run the full step; at each chunk
boundary the held test, after which the rest of the block is the
time-parallel pass; and the final state from the last row.  y starts as
NaN, so a row that no part writes shows.

The model is held bit for bit (``torch.equal``) to the plain version, which
``tests/test_torch_scan_kernels.py`` holds to the JAX package's Pallas
kernel and the card holds the kernel to (``tests/test_torch_cuda.py``,
``chip_smoke.py``), over three chained blocks of every regime of
``oscen_tpu_torch.tools.adsr_regime`` at V in {1, 31, 32, 33, 256} and B in
{1, 31, 32, 33, 1024}; one case also against the Pallas kernel in
interpret mode.  The counts of what the schedule ran pin the regimes'
paths: a sustained chord never runs a serial step, one decaying voice keeps
its warp serial to the end of the block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oscen_tpu.ops.pallas.adsr import adsr_scan as j_adsr_scan
from oscen_tpu_torch.ops.cuda import adsr as tadsr
from oscen_tpu_torch.tools import ADSR_REGIMES, adsr_regime

CHUNK, GROUP, LANES, SLICE = 32, 8, 32, 256   # adsr.cu's kChunk ... kSliceRows
NEVER = 1 << 30
IDLE, ATTACK, DECAY, SUSTAIN, RELEASE = 0.0, 1.0, 2.0, 3.0, 4.0


def clip01(x):
    return torch.clamp(x, 0.0, 1.0)


class Warp:
    """One warp's voices (the live ones: a lane beyond V holds and never
    limits the count), with ``AdsLane``'s step, count and fast body."""

    def __init__(self, st, rows):
        (self.stage, self.rem, self.level, self.target, self.sus, self.vel,
         self.rinc) = (r.clone() for r in st.unbind(0))
        self.a_n, self.d_n, self.r_n, self.a_c, self.d_c = rows
        self.count()

    def step(self, x):
        w = torch.where
        self.sus = clip01(x * self.vel)
        stage, rem, level = self.stage, self.rem, self.level
        isA, isD = stage == ATTACK, stage == DECAY
        isR, isS, isI = stage == RELEASE, stage == SUSTAIN, stage == IDLE
        cap = w(isA, self.a_n, w(isD, self.d_n, w(isR, self.r_n, rem)))
        clamped = torch.clamp_min(torch.minimum(rem, cap), 1.0)
        timed = (stage >= ATTACK) & (stage != SUSTAIN)
        r1 = w(timed & (rem > 0.0), clamped, rem)
        self.target = w(isD | isS, self.sus, w(isR, 0.0, self.target))
        cur = clip01(level)
        self.rinc = w(isR, w((r1 == 0.0) | (cur <= 0.0), 0.0,
                             -cur / torch.clamp_min(r1, 1.0)), self.rinc)
        adr = isA | isD | isR
        act = adr & (r1 > 0.0)
        r2 = w(act, r1 - 1.0, r1)
        done = adr & (r2 == 0.0)
        tg = w(isA, 1.0, self.sus)
        c = w(isA, self.a_c, self.d_c)
        e = w(isR, clip01(level + self.rinc), clip01(level + (tg - level) * c))
        kd = w(isA, 1.0, w(isD, self.sus, 0.0))
        kf = w(done, kd, w(isS, self.sus, 0.0))
        self.level = w(act & ~done, e, w(done | isS | isI, kf, level))
        self.stage = w(done, w(isA, DECAY, w(isD, SUSTAIN, IDLE)), stage)
        self.rem = w(done & isA, self.d_n, r2)
        self.target = w(done & isA, clip01(self.sus), self.target)
        self.rinc = w(done, 0.0, self.rinc)
        return self.level

    def fast_groups(self):
        stage, rem = self.stage, self.rem
        isA, isD, isR = stage == ATTACK, stage == DECAY, stage == RELEASE
        cap = torch.where(isA, self.a_n, torch.where(isD, self.d_n, self.r_n))
        ok = (isA | isD | isR) & (rem >= 1.0) & (rem <= cap) \
            & (rem <= 16777216.0) & (rem == torch.trunc(rem)) \
            & (~isR | ((self.level >= 2.0 ** -50) & (self.level <= 1.0)))
        n = torch.where(ok, (rem.to(torch.int64) - 1) // GROUP, 0)
        return torch.where((stage == SUSTAIN) | (stage == IDLE), NEVER, n)

    def count(self):
        self.fast = int(self.fast_groups().min())
        self.ad = bool(((self.stage == ATTACK) | (self.stage == DECAY)).any())
        self.r = bool((self.stage == RELEASE).any())
        self.held = bool(((self.stage == SUSTAIN)
                          | (self.stage == IDLE)).all())

    def fast_body(self, x, kAD, kR):
        """``AdsLane::fast<N, kAD, kR>``: x ``[N, W]``, returns y ``[N, W]``;
        a release's quotient is the correctly rounded -level / m (the
        kernel's is vouched for by its residual check, or the steps run
        again with the true division), its level already clipped."""
        w = torch.where
        stage = self.stage
        isA, isD = stage == ATTACK, stage == DECAY
        isR, isS = stage == RELEASE, stage == SUSTAIN
        ad = isA | isD
        c = w(isA, self.a_c, self.d_c)
        level, rq, ys = self.level, self.rinc, []
        n = x.shape[0]
        for j in range(n):
            s = clip01(x[j] * self.vel)
            lv = w(isS, s, 0.0)
            if kAD:
                e = clip01(level + (w(isA, 1.0, s) - level) * c)
                lv = w(ad, e, lv)
            if kR:
                rq = -level / (self.rem - float(j))
                lv = w(isR, clip01(level + rq), lv)
            level = lv
            ys.append(lv)
        self.level, self.sus = level, s
        self.target = w(isD | isS, s, w(isR, 0.0, self.target))
        if kR:
            self.rinc = w(isR, rq, self.rinc)
        self.rem = w(ad | isR, self.rem - float(n), self.rem)
        return torch.stack(ys)


def model_adsr_scan(st, a_n, d_n, r_n, a_c, d_c, sus, counts=None):
    """adsr_kernel's schedule; returns (levels ``[B, V]``, state7') and adds
    to ``counts``: "held0" (groups held from t = 0), "fast" / "full"
    (groups of 8 steps in the fast body / the full step), "ragged" (steps
    after a chunk's last full group), "tail" (rows of the time-parallel
    pass after the serial part)."""
    counts = {} if counts is None else counts
    B, V = sus.shape
    y = torch.full((B, V), float("nan"))
    st_out = torch.empty_like(st)
    rows = (a_n, d_n, r_n, a_c, d_c)
    for l0 in range(0, V, LANES):
        ls = slice(l0, min(l0 + LANES, V))
        wp = Warp(st[:, ls], [r[ls] for r in rows])
        x = sus[:, ls]

        def held_rows(t_lo, t_hi):
            y[t_lo:t_hi, ls] = torch.where(wp.stage == SUSTAIN,
                                           clip01(x[t_lo:t_hi] * wp.vel),
                                           0.0)
        if wp.held:   # every time slice writes its rows
            counts["held0"] = counts.get("held0", 0) + 1
            for s0 in range(0, B, SLICE):
                held_rows(s0, min(s0 + SLICE, B))
            t_lo = 0
        else:
            c, chunks = 0, -(-B // CHUNK)
            while c < chunks:
                t0 = c * CHUNK
                n = min(CHUNK, B - t0)
                slot = torch.full((CHUNK, x.shape[1]), float("nan"))
                if n == CHUNK and wp.fast >= CHUNK // GROUP:   # fast_chunk
                    wp.fast -= CHUNK // GROUP
                    slot[:] = wp.fast_body(x[t0:t0 + CHUNK], wp.ad, wp.r)
                    counts["fast"] = counts.get("fast", 0) + CHUNK // GROUP
                else:   # run_chunk: by groups, then the ragged steps
                    for g in range(n // GROUP):
                        xg = x[t0 + g * GROUP:t0 + (g + 1) * GROUP]
                        rg = slice(g * GROUP, (g + 1) * GROUP)
                        if wp.fast > 0 and not wp.r:
                            wp.fast -= 1
                            slot[rg] = wp.fast_body(xg, wp.ad, False)
                            counts["fast"] = counts.get("fast", 0) + 1
                        else:
                            for j in range(GROUP):
                                slot[g * GROUP + j] = wp.step(xg[j])
                            wp.count()
                            counts["full"] = counts.get("full", 0) + 1
                    for t in range(n // GROUP * GROUP, n):
                        slot[t] = wp.step(x[t0 + t])
                        counts["ragged"] = counts.get("ragged", 0) + 1
                y[t0:t0 + n, ls] = slot[:n]   # the write-back
                c += 1
                if wp.held:
                    break
            t_lo = min(c * CHUNK, B)
            held_rows(t_lo, B)
            counts["tail"] = counts.get("tail", 0) + B - t_lo
        if t_lo < B:   # held to the end: the last row decides
            s = clip01(x[B - 1] * wp.vel)
            on = wp.stage == SUSTAIN
            wp.sus, wp.level = s, torch.where(on, s, 0.0)
            wp.target = torch.where(on, s, wp.target)
        st_out[:, ls] = torch.stack([wp.stage, wp.rem, wp.level, wp.target,
                                     wp.sus, wp.vel, wp.rinc])
    return y, st_out


def run_blocks(regime, V, B, n_blocks=3, seed=0):
    """``n_blocks`` chained blocks of the model against the plain version
    (torch.equal on every output); returns the counts and the last state."""
    st, rows, sus = adsr_regime(regime, V, B, seed)
    counts = {}
    for i in range(n_blocks):
        got = model_adsr_scan(st, *rows, sus, counts)
        want = tadsr.plain_adsr_scan(st, *rows, sus)
        for a, b, what in zip(got, want, ("levels", "state")):
            assert torch.equal(a, b), (
                f"{regime} V={V} B={B} block {i}: {what} differ by "
                f"{float((a - b).abs().nan_to_num(1.0).max()):.3e}")
        st = got[1]
    return counts, st


SHAPES = [(V, B) for V in (1, 31, 32, 33, 256) for B in (1, 31, 32, 33,
                                                          1024)]


@pytest.mark.parametrize("regime", ADSR_REGIMES)
@pytest.mark.parametrize("V,B", SHAPES)
def test_schedule_equals_plain(regime, V, B):
    counts, st = run_blocks(regime, V, B)
    groups = -(-V // LANES)
    if regime in ("sustain", "idle", "held_mix"):
        # every warp of every block holds from t = 0: no serial step
        assert counts == {"held0": 3 * groups}
    elif regime == "one_decay":
        # the decaying voice (the sixth of every 32) keeps its warp serial:
        # no held rows; a warp without one holds from t = 0
        serial = sum(min(LANES, V - l0) > 5 for l0 in range(0, V, LANES))
        assert counts.get("held0", 0) == 3 * (groups - serial)
        assert counts.get("tail", 0) == 0
        if serial and B >= 1024:
            assert counts["fast"] > 10 * counts.get("full", 0)
    elif regime in ("gate_on", "release_idle") and B >= 1024:
        # attack and decay into sustain / release into idle within ~210
        # samples: the rest of the first block is time-parallel, and the
        # later blocks hold from t = 0
        assert counts["tail"] >= groups * (B - 256)
        assert counts["held0"] == 2 * groups
        assert bool(((st[0] == SUSTAIN) | (st[0] == IDLE)).all())
    elif regime in ("decay", "release") and B >= 1024:
        # a whole block in one stage: the fast body, but at the events
        assert counts["fast"] > 20 * counts.get("full", 0)


def test_edge_voices_end_their_stage_at_chunk_edges():
    """A decay whose last step is the last of chunk 0 (rem 32) or the first
    of chunk 1 (rem 33): the stage codes after 32 and 33 steps."""
    st, rows, sus = adsr_regime("edge", 8, 40)
    assert st[1].tolist()[:8] == [1.0, 8.0, 9.0, 31.0, 32.0, 33.0, 64.0,
                                  65.0]
    for B, want in ((32, (3, 3, 3, 3, 3, 2, 2, 2)),
                    (33, (3, 3, 3, 3, 3, 3, 2, 2))):
        y, st_b = model_adsr_scan(st, *rows, sus[:B].contiguous())
        assert tuple(int(s) for s in st_b[0]) == want
        assert torch.equal(st_b, tadsr.plain_adsr_scan(
            st, *rows, sus[:B].contiguous())[1])


def test_schedule_matches_the_pallas_kernel(monkeypatch):
    """The model against the JAX package's Pallas kernel in interpret mode
    (``OSCEN_UNROLL_CAP=1``, as ``tests/test_torch_scan_kernels.py`` runs
    it), three chained blocks of the ramp regime, at 1e-6."""
    monkeypatch.setenv("OSCEN_UNROLL_CAP", "1")
    st, rows, sus = adsr_regime("ramp", 33, 40, seed=3)
    s_j = jnp.asarray(st.numpy())
    s_t = st
    for _ in range(3):
        yj, s_j = j_adsr_scan(s_j, *(jnp.asarray(r.numpy()) for r in rows),
                              jnp.asarray(sus.numpy()), interpret=True)
        yt, s_t = model_adsr_scan(s_t, *rows, sus)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6,
                                   rtol=0)
    assert float(np.abs(np.asarray(yj)).max()) > 0.1
