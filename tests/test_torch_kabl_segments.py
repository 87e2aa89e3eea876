"""K16's time segments and K17's per-lane short wrap, modelled in PyTorch
on the CPU (the algorithms of ``csrc/kabl.cu``, ``csrc/kabl_hmaj.cu``,
``csrc/kabl_scan.cuh`` and ``csrc/fractabl.cu``).

K16: each voice's block is split at subgroup boundaries into S segments,
and a segment that starts at subgroup K rebuilds the state the one-warp
body holds there (``replay_rows``; kernel C's replay in its kernel): the
oscillator rotated by ``m^SUB`` (kernel C: the given ``msr`` / ``msi``)
once per subgroup, the cycle's ``(tgt, D)`` by the rule's wrap flag, and
the step and the carry ``p`` by the variant's ROWS rule:

- ``recur`` (v3's chain) and ``recur2`` (kabl2's ``(tgt, D)`` rule): K3's
  ``replay()``: whole subgroups of the tick loop while a subgroup starts
  with the step off its integer cycle 0..64, the cycle in closed form
  after, and ``p`` walked from the last wrap (at most 65 ticks);
- ``scan`` (kabl6 v5, and kernel C's rows): the step per subgroup from
  the scan's last row, and ``p`` scanned only from the last subgroup whose
  last tick wraps (which sets ``p`` whatever it was);
- ``fixed``, ``const``, ``base``, ``loads`` and the one-hot rows: the step
  once per subgroup by the rule, ``p`` = 1.

Each model is held ``torch.equal`` (NaN equal to NaN) to the plain
variant run in one piece (``plain_body`` / ``plain_hmaj_body`` of
``ops/cuda/kabl.py``, which ``chip_smoke.py`` and the card tests hold the
kernels to): the state at every segment start, the per-tick rows (per
voice) of the segments run from the replayed states, the state planes
after the block, and the voice mix in the kernel's order (2 or 8 warps a
block in warp order, groups of 16 blocks, then the groups).  B in {256,
1024, 4096}, every S the kernel's rule allows (kernels A and B: 1, 2, 4
dividing the subgroups; kernel C: 1 .. 16), and the entry steps 0, 1, 63,
64 and ``ODD_STEPS`` (fractions, negatives, steps above 64, -0.0, a
denormal, 2^24, stuck counters, +-inf, NaN) among the voices.  The segment
counts the card picks are tested there (``tests/test_torch_cuda.py``).
B=4096 runs the rules whose replay walks the block (``full``, ``recur``,
``scan``, ``scan64``) and kernel C, to keep the file to seconds.

K17: every layout steps a lane by the short exact wrap ``q - (q >= 1)``
where its p0 and dt both lie in ``[+0, 1)`` (on their bits), by ``q -
trunc(q)`` elsewhere, each lane on its own (packed: each of a thread's two
lanes); the model of each layout is held to its plain version on the bit
patterns, with lanes of both kinds and every pair of packed choices.
"""

import numpy as np
import pytest
import torch

from oscen_tpu_torch.ops.cuda import fractabl as tfa
from oscen_tpu_torch.ops.cuda import kabl as tk

H = 2
C = 63.0 / 64.0
F32 = np.float32
# the cycle's edges and a few steps on it
CYCLE_STEPS = (0.0, 1.0, 63.0, 64.0, 33.0, 2.0, 50.0)
# entry steps the envelope never produces (as
# tests/test_torch_additive_segments.py): off the cycle by a fraction,
# below 0, above 64, a +1 that rounds to an integer, the float below 64,
# stuck counters (s + 1 == s), inf, NaN
ODD_STEPS = (0.5, 64.5, 70.0, -3.0, -0.0, 1e-10, -1e-10, -2.5,
             float(np.nextafter(F32(64), F32(0))), 65.0, 1e-40, 2.0 ** 24,
             -2.0 ** 25, -1e9, float("nan"), float("inf"), float("-inf"))
STEPS = CYCLE_STEPS + ODD_STEPS
V = len(STEPS)
# one body per ROWS rule (and the SUB = 64 instances): the others switch
# what a tick computes or how it is reduced, not the state
BODIES = ("full", "sub64", "recur", "no_rows", "const_rows", "base",
          "loads", "scan", "scan64", "dot32", "onehot_sub", "onehot_all")


def _same(a, b):
    """torch.equal, with NaN equal to NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def _inputs(B, seed=0):
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.001, 0.2, (H, V))
    planes = dict(osc_re=rng.normal(size=(H, V)), osc_im=rng.normal(
        size=(H, V)), mul_re=np.cos(th), mul_im=np.sin(th),
        cur=rng.uniform(0, 1, (H, V)), tgt=rng.uniform(0, 1, (H, V)),
        mult=rng.uniform(0.9, 1.0, (H, V)))
    x = {k: torch.tensor(np.asarray(v, F32)) for k, v in planes.items()}
    x["step"] = torch.tensor(np.asarray(STEPS, F32))[None, :]
    # a random one-hot table (its bf16 values exact in float32)
    x["tbl"] = torch.tensor(rng.uniform(0, 0.5, (4 * B, tk.TBL_COLS))
                            .astype(F32)).to(torch.bfloat16)
    # kernel C's tables from the same angles (hmaj_tables: float64 sin /
    # cos rounded once), and its rows for hmaj_x
    tabs = tk.hmaj_tables(th, 32)
    x.update({k: torch.tensor(v) for k, v in tabs.items()})
    return x


def _on_cycle(s):
    return (s == torch.floor(s)) & (s >= 0.0) & (s <= 64.0)


def _power(mr, mi, sub):
    """m^SUB by the kernel's running-product recurrence."""
    msr, msi = mr, mi
    for _ in range(sub - 1):
        msr, msi = msr * mr - msi * mi, msr * mi + msi * mr
    return msr, msi


def _scan_step(s, sub):
    """``scan_step`` (kabl_scan.cuh): the last tick's wrap flag, and the
    step after the subgroup, from the scan's last row."""
    s0z = s == 0.0
    S = s + float(sub - 1)
    wr = (S >= 65.0) | s0z
    se = torch.where(wr, S - torch.where(s0z, 0.0, 65.0), S)
    return wr, torch.where(se < 64.0, se + 1.0, 0.0)


def _step_rule(rows, s, sub):
    """``step_subgroup`` (kabl.cu): the wrap flag and the next step of the
    rows whose step moves once per subgroup."""
    if rows == "fixed":
        return torch.zeros_like(s, dtype=torch.bool), s
    if rows == "const":
        s = torch.where(s + float(sub) < 65.0, s + float(sub), s)
        return s == 0.0, s
    w = (s == 0.0) | (s >= 66.0 - sub)
    t = s + float(sub)
    return w, torch.where(t >= 65.0, t - 65.0, t)


def _rotate(zr, zi, msr, msi):
    return zr * msr - zi * msi, zr * msi + zi * msr


def _replay_recur(x, K, sub, w2):
    """K3's ``replay()`` (v3; with ``w2`` kabl2's ``(tgt, D)`` rule) on
    whole planes: the state at subgroup K.  Per voice, (a) whole subgroups
    of the tick loop while a subgroup starts off the cycle, (b) the
    cycle's closed form per subgroup, remembering the tick tw and step sw
    that p is walked from (the last wrap, else the switch), (c) p by the
    tick loop's ops from tw to K x SUB.  Also returns the most ticks any
    voice on the cycle walked for p."""
    zr, zi, tgt, D, s, p = tk.entry_state(x["osc_re"], x["osc_im"],
                                          x["cur"], x["tgt"], x["step"])
    msr, msi = _power(x["mul_re"], x["mul_im"], sub)
    mult = x["mult"]
    walking = torch.ones_like(s, dtype=torch.bool)
    tw = torch.zeros_like(s, dtype=torch.int64)
    sw = s.clone()
    for k in range(K):
        switch = walking & _on_cycle(s)
        tw = torch.where(switch, k * sub, tw)
        sw = torch.where(switch, s, sw)
        walking = walking & ~switch
        tgtm = tgt * mult
        G1 = tgtm - tgt
        jw = torch.where(s == 0.0, 0.0, 65.0 - s)
        wrapped = jw <= float(sub - 1)
        hit = ~walking & wrapped
        tw = torch.where(hit, k * sub + torch.where(hit, jw, 0.0).long(), tw)
        sw = torch.where(hit, 0.0, sw)
        t = s + float(sub)
        s_next = torch.where(t >= 65.0, t - 65.0, t)
        if bool(walking.any()):   # (a): the tick loop itself
            sa, pa = s, p
            wa = torch.zeros_like(walking)
            for _ in range(sub):
                wrap = sa == 0.0
                wa = wa | wrap
                pa = torch.where(wrap, C, pa * (1.0 - (sa + 1.0) / 64.0))
                sa = torch.where(sa < 64.0, sa + 1.0, 0.0)
            wrapped = torch.where(walking, wa, wrapped)
            p = torch.where(walking, pa, p)
            s_next = torch.where(walking, sa, s_next)
        s = s_next
        w = ((s == 0.0) | (s >= 66.0 - sub)) if w2 else wrapped
        zr, zi = _rotate(zr, zi, msr, msi)
        tgt = torch.where(w, tgtm, tgt)
        D = torch.where(w, -G1, D)
    switch = walking & _on_cycle(s)
    tw = torch.where(switch, K * sub, tw)
    sw = torch.where(switch, s, sw)
    walking = walking & ~switch
    # (c): a voice still off the cycle walks no p (tw = K x SUB)
    t_w = torch.where(walking, K * sub, tw)
    for i in range(int(t_w.min()) if K else 0, K * sub):
        act = i >= t_w
        p = torch.where(act, torch.where(sw == 0.0, C, p * (
            1.0 - (sw + 1.0) / 64.0)), p)
        sw = torch.where(act, sw + 1.0, sw)
    on = _on_cycle(x["step"])
    walked = int((K * sub - t_w)[on].max()) if K else 0
    return (zr, zi, tgt, D, s, p), walked


def _replay_scan_p(step, K, sub):
    """``scan_replay_p`` (kabl_scan.cuh) on a row of steps: p at subgroup
    K, scanned from the last subgroup before K whose last tick wraps (or
    from 0).  Also returns the most subgroups any voice on the cycle
    scanned."""
    s = step
    kr = torch.full_like(s, -1, dtype=torch.int64)
    entry = []
    for k in range(K):
        entry.append(s)
        wr, s = _scan_step(s, sub)
        kr = torch.where(wr, k, kr)
    k_start = torch.clamp(kr, min=0)
    p = torch.ones_like(step)
    for k in range(int(k_start.min()) if K else 0, K):
        _, _, p_n, _, _ = tk.rows_scan(p, entry[k], sub)
        p = torch.where(k >= k_start, p_n, p)
    on = _on_cycle(step)
    scanned = int((K - k_start)[on].max()) if K else 0
    return p, scanned


def _replay(body, x, K):
    """``replay_rows`` (kabl.cu) on whole planes: (the state at subgroup
    K, the most ticks (recur) or subgroups (scan) a voice on the cycle
    walked for p)."""
    sp = tk.VARIANTS[body]
    sub = sp.sub
    if sp.rows in ("recur", "recur2"):
        return _replay_recur(x, K, sub, sp.rows == "recur2")
    zr, zi, tgt, D, s, p = tk.entry_state(x["osc_re"], x["osc_im"],
                                          x["cur"], x["tgt"], x["step"])
    msr, msi = _power(x["mul_re"], x["mul_im"], sub)
    for _ in range(K):
        tgtm = tgt * x["mult"]
        G1 = tgtm - tgt
        zr, zi = _rotate(zr, zi, msr, msi)
        if sp.rows == "scan":
            w, s = _scan_step(s, sub)
        else:
            w, s = _step_rule(sp.rows, s, sub)
        tgt = torch.where(w, tgtm, tgt)
        D = torch.where(w, -G1, D)
    walked = 0
    if sp.rows == "scan":
        p, walked = _replay_scan_p(x["step"], K, sub)
    return (zr, zi, tgt, D, s, p), walked


def _replay_hmaj(x, K):
    """Kernel C's replay: each harmonic rotated by msr / msi K times and
    its voice's (tgt, D) stepped by the scan's wrap flags; the rows' step
    and carry as ``scan``'s."""
    zr, zi, tgt, D, s, _ = tk.entry_state(x["osc_re"], x["osc_im"],
                                          x["cur"], x["tgt"], x["step"])
    for _ in range(K):
        tgtm = tgt * x["mult"]
        G1 = tgtm - tgt
        zr, zi = _rotate(zr, zi, x["msr"], x["msi"])
        w, s = _scan_step(s, 32)
        tgt = torch.where(w, tgtm, tgt)
        D = torch.where(w, -G1, D)
    p, scanned = _replay_scan_p(x["step"], K, 32)
    return (zr, zi, tgt, D, s, p), scanned


def _kernel_mix(rows, warps, group=16):
    """The voice mix in the kernel's order: 0 + each block's warps in warp
    order, 0 + each group's blocks in block order, 0 + the groups."""
    B, nv = rows.shape
    nb = -(-nv // warps)
    blk = []
    for b in range(nb):
        acc = torch.zeros(B)
        for w in range(warps):
            if b * warps + w < nv:
                acc = acc + rows[:, b * warps + w]
        blk.append(acc)
    out = torch.zeros(B)
    for g in range(0, nb, group):
        acc = torch.zeros(B)
        for r in blk[g:g + group]:
            acc = acc + r
        out = out + acc
    return out


def _hmaj_mix(acc, group=16):
    """Kernel C's voice mix: per block of 32 voices (zeros past V) the
    warp's xor butterfly (lane 0's sum), then the blocks as
    ``_kernel_mix`` sums them."""
    B, nv = acc.shape
    nb = -(-nv // 32)
    x = torch.zeros((B, nb * 32))
    x[:, :nv] = acc
    x = x.reshape(B, nb, 32)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = x + x[:, :, lane ^ o]
    return _kernel_mix(x[:, :, 0], 1, group)


def _run(body, x, k0, k1, state):
    return tk.plain_body(body, state, x["mul_re"], x["mul_im"], x["mult"],
                         k0, k1, x["step"], x["tbl"])


def _counts(n_sub, most):
    """The segment counts a kernel may run at n_sub subgroups: powers of
    two up to ``most`` dividing them."""
    return [S for S in (1, 2, 4, 8, 16) if S <= most and n_sub % S == 0]


# B=4096 for the rules whose replay walks the block (K3's replay, the
# scan's carry); the closed-form rules step a few ops a subgroup
CASES = ([(body, B) for body in BODIES for B in (256, 1024)]
         + [(body, 4096) for body in ("full", "recur", "scan", "scan64")])


@pytest.mark.parametrize("body,B", CASES)
def test_segments_equal_the_plain_variant(body, B):
    """Every S the kernel allows (1, 2, 4 dividing the subgroups): each
    segment start's replayed state equals the one-piece run's state there;
    the rows of the segments run from the replayed states equal the
    one-piece rows; the state after the block and the voice mix in the
    kernel's order (2 warps a block in kernel A, 8 in B) too, NaN equal to
    NaN.  A replay walks p over at most 65 ticks (recur) or 3 subgroups
    (scan) for a voice whose entry step is on the cycle."""
    x = _inputs(B, seed=B)
    sp = tk.VARIANTS[body]
    n_sub = B // sp.sub
    counts = _counts(n_sub, 4)
    starts = sorted({seg * (n_sub // S) for S in counts for seg in range(S)})
    # the one piece, run subgroup range by subgroup range (the plain body
    # is a loop over subgroups, so this is its one-piece run) to read its
    # state at every segment start
    state = tk.entry_state(x["osc_re"], x["osc_im"], x["cur"], x["tgt"],
                           x["step"])
    rows, at = [], {}
    for a, b in zip(starts, starts[1:] + [n_sub]):
        at[a] = state
        r, state = _run(body, x, a, b, state)
        rows += r
    final = state
    kern_b = tk.kernel_of(body) == tk.KERNEL_B
    replayed = {K: _replay(body, x, K) for K in starts}
    for K in starts:
        got, walked = replayed[K]
        for a, b in zip(got, at[K]):
            assert _same(a, b), (body, B, K)
        assert walked <= (65 if sp.rows in ("recur", "recur2") else 3)
    # the segments of the largest count from their replayed states (a
    # smaller count's starts are among them)
    S = counts[-1]
    n = n_sub // S
    seg_rows = []
    for seg in range(S):
        r, st = _run(body, x, seg * n, (seg + 1) * n, replayed[seg * n][0])
        seg_rows += r
    assert len(seg_rows) == len(rows) == B
    for a, b in zip(seg_rows, rows):
        assert _same(a, b)
    for a, b in zip(st, final):
        assert _same(a, b)
    R = torch.stack(seg_rows)
    assert _same(_kernel_mix(R, 8 if kern_b else 2),
                 _kernel_mix(torch.stack(rows), 8 if kern_b else 2))


@pytest.mark.parametrize("B", [256, 1024, 4096])
def test_hmaj_segments_equal_the_plain_version(B):
    """Kernel C (kabl5's harmonic-major form) in every S its rule allows
    (1 .. 16 dividing the B / 32 subgroups): the replayed state at every
    segment start equals the one-piece run's, the accumulators of the
    segments run from it equal the one-piece ones, the voice mix (one tile,
    and two) too, NaN equal to NaN; hmaj_x's read rows keep the scan's
    carry alike."""
    x = _inputs(B, seed=3 * B)
    n_sub = B // 32
    counts = _counts(n_sub, 16)
    starts = sorted({seg * (n_sub // S) for S in counts for seg in range(S)})
    args = (x["ti3"], x["tr3"], x["msr"], x["msi"], x["mult"])
    state = tk.entry_state(x["osc_re"], x["osc_im"], x["cur"], x["tgt"],
                           x["step"])
    accs, at = [], {}
    for a, b in zip(starts, starts[1:] + [n_sub]):
        at[a] = state
        acc, state = tk.plain_hmaj_body(state, *args, a, b)
        accs += acc
    final = state
    replayed = {K: _replay_hmaj(x, K) for K in starts}
    for K in starts:
        got, scanned = replayed[K]
        for a, b in zip(got, at[K]):
            assert _same(a, b), (B, K)
        assert scanned <= 3
    S = counts[-1]
    n = n_sub // S
    seg_accs = []
    for seg in range(S):
        acc, st = tk.plain_hmaj_body(replayed[seg * n][0], *args, seg * n,
                                     (seg + 1) * n)
        seg_accs += acc
    for a, b in zip(seg_accs, accs):
        assert _same(a, b)
    for a, b in zip(st, final):
        assert _same(a, b)
    one = torch.cat(accs)
    seg = torch.cat(seg_accs)
    for tiles in (1, 2):
        w = -(-V // tiles)
        for t in range(tiles):
            assert _same(_hmaj_mix(seg[:, t * w:(t + 1) * w]),
                         _hmaj_mix(one[:, t * w:(t + 1) * w]))
    # hmaj_x: rows read from [B, V], the carry still the scan's
    r1 = torch.tensor(np.random.default_rng(B).uniform(0, 1, (B, V))
                      .astype(F32))
    _, st_x = tk.plain_hmaj_body(replayed[n_sub - n][0], *args, n_sub - n,
                                 n_sub, r1, r1)
    for a, b in zip(st_x[4:], final[4:]):
        assert _same(a, b)


def test_the_models_pass_through_every_replay_path():
    """The cases above reach what each replay treats apart: at B=1024
    some voice on the cycle walks p from a wrap (recur), some starts its
    scan at a resetting subgroup after tick 0 (scan), and the stuck
    counters walk every subgroup by ticks."""
    x = _inputs(1024)
    _, walked = _replay_recur(x, 24, 32, False)
    assert 0 < walked <= 65
    _, scanned = _replay_scan_p(x["step"], 24, 32)
    assert 1 <= scanned <= 3
    (_, _, _, _, s, _), _ = _replay_recur(x, 24, 32, False)
    stuck = torch.tensor([v in (-2.0 ** 25, -1e9, float("-inf"))
                          for v in STEPS])
    assert torch.equal(s[0, stuck], x["step"][0, stuck])


# ------------------------------------------------------------------ #
# K17: the per-lane short wrap in every store layout
# ------------------------------------------------------------------ #
def _bits(t):
    return t.contiguous().view(torch.int32)


def _in_unit(t):
    b = _bits(t)
    return (b >= 0) & (b < 0x3F800000)


def _step(p, d, short):
    q = p + d
    return torch.where(short, q - (q >= 1.0).to(torch.float32),
                       q - torch.trunc(q))


def _model_layout(layout, phases, dt, B):
    """``fract_abl_kernel<LAYOUT>``: each lane's wrap chosen once from its
    p0 and dt (packed: each of a thread's two lanes apart; seg: one choice
    for both phases); the layout's raw output and carry."""
    short = _in_unit(phases) & _in_unit(dt)
    if layout in ("direct", "packed"):
        out = torch.empty((B,) + tuple(phases.shape))
        p = phases
        for t in range(B):
            out[t] = p
            p = _step(p, dt, short)
        return out, p
    S, seg = tfa.S, B // tfa.S
    Vn = phases.shape[1]
    bounds, p = [phases], phases
    for _ in range(S - 1):
        for _ in range(seg):
            p = _step(p, dt, short)
        bounds.append(p)
    P = torch.stack(bounds, dim=1)              # [3, S, V]
    dP = dt[:, None, :].expand(3, S, Vn)
    sP = short[:, None, :].expand(3, S, Vn)
    out = torch.empty((seg, 3 * S, Vn))
    for j in range(seg):
        out[j] = P.reshape(3 * S, Vn)
        P = _step(P, dP, sP)
    return out, P[:, S - 1]


def _fract_lanes(Vn, seed):
    """p0 and dt ``[3, Vn]``: lanes in [+0, 1) (the short wrap) beside
    negatives, -0.0, 1.0, values above 1, +-inf and NaN, shuffled so that
    a packed thread's two lanes take every pair of choices."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, (3, Vn)).astype(F32)
    d = rng.uniform(0, 0.5, (3, Vn)).astype(F32)
    odd = np.array([-0.25, -0.0, 1.0, 1.5, np.inf, -np.inf, np.nan,
                    F32(1) - F32(2.0 ** -24), -3.75, 7.5], F32)
    flat_p, flat_d = p.reshape(-1), d.reshape(-1)
    pick = rng.choice(flat_p.size, flat_p.size // 2, replace=False)
    flat_p[pick[::2]] = rng.choice(odd, pick[::2].size)
    flat_d[pick[1::2]] = rng.choice(odd, pick[1::2].size)
    return torch.tensor(p), torch.tensor(d)


@pytest.mark.parametrize("B", [64, 256])
@pytest.mark.parametrize("layout", tfa.LAYOUTS)
def test_fract_layouts_short_wrap_per_lane(layout, B):
    """Each layout's model (the short wrap on a lane whose p0 and dt lie
    in [+0, 1), truncf elsewhere) equals its plain version on the bit
    patterns, every output; both kinds of lane are present, and packed
    threads hold every pair of choices."""
    p, d = _fract_lanes(64, seed=B)
    short = _in_unit(p) & _in_unit(d)
    assert bool(short.any()) and bool((~short).any())
    pairs = short.reshape(-1, 2)
    kinds = {(bool(a), bool(b)) for a, b in pairs}
    assert len(kinds) == 4
    got = _model_layout(layout, p, d, B)
    want = tfa.PLAIN[layout](p, d, B)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
