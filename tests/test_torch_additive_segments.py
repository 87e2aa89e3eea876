"""The additive kernels' time segments, modelled in PyTorch on the CPU:
each voice's block split at subgroup boundaries into S segments, each
segment starting from the state ``csrc/additive.cu``'s ``replay()``
rebuilds (the oscillator rotated by ``m^SUB`` and the cycle's ``(tgt, D)``
over the subgroups before it).  v4 steps its counter per subgroup and
replays ``p`` tick by tick from the last subgroup whose wrap tick resets
it.  v3 and v2 walk whole subgroups with their own tick loop only while a
subgroup starts with the step off its integer cycle 0..64; on the cycle
they step ``(tgt, D)`` and the step once per subgroup and walk ``p`` from
the last wrap, at most 65 ticks.

Held ``torch.equal`` to the plain versions ``plain_v4``, ``plain_v3`` and
``plain_v2`` run in one piece: the per-voice rows of every tick, the state
planes after the block, and the voice mix summed in the kernel's order
(two warps per block in warp order, groups of 16 blocks in block order,
then the groups in order) from either's rows.  B in {64, 256, 1024, 4096}
(one to 64 subgroups of 64 ticks), S in {1, 2, 4, 8, 16} where S divides
the subgroups, and the entry steps 0, 1, 63 and 64 among the voices; a
segment's replay window holds a wrap for every B >= 256.  Entry steps the
envelope never produces (``ODD_STEPS``: fractions, negatives, steps above
64, -0.0, a denormal, 2^24, stuck counters, +-inf, NaN) at B=1024 and
4096 with every S the subgroups allow, NaN equal to NaN: the replay is
exact for any input.  The model takes the closed form for every voice on
the cycle, and the kernel's v2 body (its selects switch ``(tgt, D)`` in
place) equals ``plain_v2``.  The segment count the card picks is tested
there (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from oscen_tpu_torch.ops.cuda import additive as tadd

H = 32
C = 63.0 / 64.0
STEPS = (0.0, 1.0, 63.0, 64.0, 33.0, 2.0, 50.0, 20.0, 62.0, 5.0)


def _planes(V=10, seed=0):
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 0.2, (H, V))
    planes = [rng.normal(size=(H, V)), rng.normal(size=(H, V)), np.cos(th),
              np.sin(th), rng.uniform(0, 1, (H, V)), rng.uniform(0, 1, (H, V)),
              rng.uniform(0.9, 1.0, (H, V))]
    step = np.asarray(STEPS[:V], np.float32)
    return ([torch.tensor(np.asarray(p, np.float32)) for p in planes],
            torch.tensor(step))


def _on_cycle(s):
    """The step counter on its integer cycle 0..64 (-0.0 counts as 0)."""
    return (s == torch.floor(s)) & (s >= 0.0) & (s <= 64.0)


def _power(mr, mi, sub):
    """m^SUB by the kernel's running-product recurrence."""
    msr, msi = mr, mi
    for _ in range(sub - 1):
        msr, msi = msr * mr - msi * mi, msr * mi + msi * mr
    return msr, msi


def _entry(planes, step):
    """The block-start (tgt, D, s, p): a wrap at the first tick takes its
    cycle base from cur."""
    cur, tgt_in = planes[4], planes[5]
    s = step.clone()
    tgt = torch.where(s == 0.0, cur, tgt_in)
    return tgt, cur - tgt, s, torch.ones_like(s)


def _replay_v4(planes, step, K, sub):
    """v4's replay() of csrc/additive.cu on whole planes: the state at the
    start of subgroup K; also whether some voice's window starts at a
    subgroup that resets p."""
    zr, zi, mult = planes[0], planes[1], planes[6]
    msr, msi = _power(planes[2], planes[3], sub)
    tgt, D, s, p = _entry(planes, step)
    kr = torch.full_like(s, -1.0)
    sr = torch.zeros_like(s)
    s_entry = []
    for k in range(K):
        s_entry.append(s)
        tgtm = tgt * mult
        G1 = tgtm - tgt
        jw = torch.where(s == 0.0, 0.0, 65.0 - s)
        w = jw <= float(sub - 1)
        reset = w & (jw >= 0.0) & (jw == torch.floor(jw))
        kr = torch.where(reset, float(k), kr)
        sr = torch.where(reset, s, sr)
        zr, zi = zr * msr - zi * msi, zr * msi + zi * msr
        tgt = torch.where(w, tgtm, tgt)
        D = torch.where(w, -G1, D)
        t = s + float(sub)
        s = torch.where(t >= 65.0, t - 65.0, t)
    # p: from the start of the last subgroup that resets it (or tick 0),
    # v4's per-tick factors; earlier subgroups leave p at 1
    k_start = torch.where(kr >= 0, kr, 0.0)
    for k in range(int(k_start.min()) if K else 0, K):
        act = k >= k_start
        sk = s_entry[k]
        at0 = sk == 0.0
        jw = torch.where(at0, 0.0, 65.0 - sk)
        basef = sk * (-1.0 / 64.0)
        addf = torch.where(at0, 0.0, 65.0 / 64.0)
        for j in range(sub):
            wfb = jw <= float(j)
            f = (basef + (63.0 - float(j)) * (1.0 / 64.0)) + torch.where(
                wfb, addf, 0.0)
            p = torch.where(act, torch.where(jw == float(j), C, p * f), p)
    return (zr, zi, tgt, D, s, p), bool((kr >= 0).any())


def _replays_v32(version, planes, step, Ks, sub):
    """v3's or v2's replay() of csrc/additive.cu on whole planes, for every
    segment start K in ``Ks``: {K: (state, info)}.  Per voice, (a) whole
    subgroups of the tick loop while a subgroup starts off the cycle, (b)
    the cycle's closed form per subgroup after, remembering the tick tw
    and step sw p is walked from (the last wrap, else the switch), (c) p
    by the tick loop's ops from tw to K x SUB.  One pass over the
    subgroups serves every K: the kernel replays each segment from the
    block start, and (a) and (b) reach the same state at subgroup k
    whichever K they run to.  ``info``: the subgroups each voice walked by
    ticks (``walked``), the ticks of its p walk (``p_ticks``), and whether
    that walk starts at a wrap (``from_wrap``)."""
    zr, zi, mult = planes[0], planes[1], planes[6]
    msr, msi = _power(planes[2], planes[3], sub)
    tgt, D, s, p = _entry(planes, step)
    walking = torch.ones_like(s, dtype=torch.bool)     # still in (a)
    walked = torch.zeros_like(s, dtype=torch.int64)
    tw = torch.zeros_like(walked)
    sw = s.clone()
    from_wrap = torch.zeros_like(walking)
    out = {}
    for k in range(max(Ks) + 1):
        switch = walking & _on_cycle(s)
        tw = torch.where(switch, k * sub, tw)
        sw = torch.where(switch, s, sw)
        walking = walking & ~switch
        if k in Ks:
            # (c): a voice still off the cycle walks no p (tw = K x SUB)
            t_w = torch.where(walking, k * sub, tw)
            pk, swk = p, sw
            for i in range(int(t_w.min()), k * sub):
                act = i >= t_w
                pk = torch.where(act, torch.where(
                    swk == 0.0, C, pk * (1.0 - (swk + 1.0) / 64.0)), pk)
                swk = torch.where(act, swk + 1.0, swk)
            out[k] = ((zr, zi, tgt, D, s, pk),
                      {"walked": walked, "p_ticks": k * sub - t_w,
                       "from_wrap": from_wrap & ~walking})
        if k == max(Ks):
            break
        tgtm = tgt * mult
        G1 = tgtm - tgt
        D2 = tgt - tgtm
        # (b): the subgroup from an integer s wraps at tick (65 - s) mod 65
        jw = torch.where(s == 0.0, 0.0, 65.0 - s)
        wrapped = jw <= float(sub - 1)
        hit = ~walking & wrapped
        tw = torch.where(hit, k * sub + torch.where(hit, jw, 0.0).long(), tw)
        sw = torch.where(hit, 0.0, sw)
        from_wrap = from_wrap | hit
        t = s + float(sub)
        s_next = torch.where(t >= 65.0, t - 65.0, t)
        if bool(walking.any()):   # (a): the kernel's own tick loop
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
            walked = walked + walking.long()
        s = s_next
        zr, zi = zr * msr - zi * msi, zr * msi + zi * msr
        tgt = torch.where(wrapped, tgtm, tgt)
        D = torch.where(wrapped, D2 if version == "v2" else -G1, D)
    return out


def _replays(version, planes, step, Ks, sub):
    """{K: (state, whether some voice's p walk starts at a wrap or a
    resetting subgroup)} for every segment start K in ``Ks``."""
    if version == "v4":
        return {K: _replay_v4(planes, step, K, sub) for K in Ks}
    return {K: (st, bool(info["from_wrap"].any())) for K, (st, info)
            in _replays_v32(version, planes, step, Ks, sub).items()}


_ROWS = {"v4": tadd._rows_v4, "v3": tadd._rows_v3, "v2": tadd._rows_v2}


def _segment(version, planes, state, sub, n_sub):
    """n_sub subgroups of the plain closed form from a replayed state:
    (per-voice rows [n_sub * sub, V], the last tick's amp, the state)."""
    zr, zi, tgt, D, s, p = state
    mr, mi, mult = planes[2], planes[3], planes[6]
    mjr, mji = [mr], [mi]
    for _ in range(sub - 1):
        pr, pi = mjr[-1], mji[-1]
        mjr.append(pr * mr - pi * mi)
        mji.append(pr * mi + pi * mr)
    msr, msi = mjr[-1], mji[-1]
    mjr3, mji3 = torch.stack(mjr) * 3.0, torch.stack(mji) * 3.0
    j_idx = torch.arange(sub, dtype=torch.float32)[:, None]
    rows = []
    amp = None
    for _ in range(n_sub):
        amp, tgt, D, p, s = _ROWS[version](tgt, D, p, s, mult, sub, j_idx)
        rows.append((zr * mji3 + zi * mjr3) * amp)
        zr, zi = zr * msr - zi * msi, zr * msi + zi * msr
    y = torch.cat([(r).sum(dim=1) for r in rows])
    return y, amp[-1], (zr, zi, tgt, s)


def _segmented(version, planes, step, B, S):
    sub = tadd.subgroup_len(B, version)
    n = B // sub // S
    ys, any_wrap = [], False
    replays = _replays(version, planes, step, [seg * n for seg in range(S)],
                       sub)
    for seg in range(S):
        state, wrapped = replays[seg * n]
        any_wrap |= wrapped
        y, cur_last, (zr, zi, tgt, s) = _segment(version, planes, state,
                                                 sub, n)
        ys.append(y)
    return torch.cat(ys), (zr, zi, cur_last, tgt, s), any_wrap


def _kernel_mix(y, warps=2, group=16):
    """The voice mix in the kernel's order: 0 + each block's warps in warp
    order, 0 + each group's blocks in block order, 0 + the groups."""
    B, V = y.shape
    nb = -(-V // warps)
    rows = []
    for b in range(nb):
        acc = torch.zeros(B)
        for w in range(warps):
            if b * warps + w < V:
                acc = acc + y[:, b * warps + w]
        rows.append(acc)
    groups = []
    for g in range(0, nb, group):
        acc = torch.zeros(B)
        for r in rows[g:g + group]:
            acc = acc + r
        groups.append(acc)
    out = torch.zeros(B)
    for g in groups:
        out = out + g
    return out


_PLAIN = {}


def _plain(version, B):
    if (version, B) not in _PLAIN:
        planes, step = _planes()
        _PLAIN[(version, B)] = tadd._CLOSED[version](
            *planes, step, B, tadd.subgroup_len(B, version))
    return _PLAIN[(version, B)]


CASES = [(B, S) for B in (64, 256, 1024, 4096) for S in (1, 2, 4, 8, 16)
         if (B // tadd.subgroup_len(B, "v4")) % S == 0]


@pytest.mark.parametrize("version", ["v4", "v3", "v2"])
@pytest.mark.parametrize("B,S", CASES)
def test_segments_equal_the_plain_version(version, B, S):
    planes, step = _planes()
    y, state, any_wrap = _segmented(version, planes, step, B, S)
    y_p, *state_p = _plain(version, B)
    assert torch.equal(y, y_p)
    for a, b in zip(state, state_p):
        assert torch.equal(a, b)
    assert torch.equal(_kernel_mix(y), _kernel_mix(y_p))
    if S > 1 and B >= 256:
        assert any_wrap   # some replay window starts at a wrap


def _same(a, b):
    """torch.equal, with NaN equal to NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


F32 = np.float32
# entry steps the envelope never produces, and the cycle's own edges: off
# the cycle by a fraction, below 0, above 64, a +1 that rounds to an
# integer (1e-10, -1e-10, a denormal), one that rounds to 65 (the float
# below 64), counters that stick (s + 1 == s: -2^25, -1e9, -inf), inf, NaN
ODD_STEPS = (0.5, 64.5, 70.0, -3.0, -0.0, 1e-10, -1e-10, -2.5,
             float(np.nextafter(F32(64), F32(0))), 64.0, 65.0, 1e-40,
             2.0 ** 24, -2.0 ** 25, -1e9, float("nan"), float("inf"),
             float("-inf"))
ODD_CASES = ([(1024, S) for S in (1, 2, 4, 8, 16)]
             + [(4096, S) for S in (1, 2, 4, 8, 16, 32, 64)])


@pytest.mark.parametrize("version", ["v4", "v3", "v2"])
@pytest.mark.parametrize("B,S", ODD_CASES)
def test_segments_equal_one_piece_for_entry_steps_outside_0_64(version, B,
                                                                S):
    """Entry steps the envelope never produces (``ODD_STEPS``): the
    segments still equal the version in one piece, bit for bit (NaN equal
    to NaN), the rows, the state and the voice mix in the kernel's order,
    for every segment count the subgroups allow."""
    planes, _ = _planes(len(ODD_STEPS), seed=3)
    step = torch.tensor(ODD_STEPS, dtype=torch.float32)
    y, state, _ = _segmented(version, planes, step, B, S)
    y_1, *state_1 = tadd._CLOSED[version](
        *planes, step, B, tadd.subgroup_len(B, version))
    assert _same(y, y_1)
    for a, b in zip(state, state_1):
        assert _same(a, b)
    assert _same(_kernel_mix(y), _kernel_mix(y_1))


def _first_on_cycle(step, sub, n):
    """Per voice, the first of n subgroup starts whose step is an integer
    in 0..64, by the tick loop's step ops in float32 (n if none is)."""
    s = step.numpy().astype(F32)
    first = np.full(s.shape, n)
    with np.errstate(invalid="ignore"):
        for k in range(n):
            on = (s == np.floor(s)) & (s >= 0) & (s <= 64)
            first = np.where(on & (first == n), k, first)
            for _ in range(sub):
                s = np.where(s < F32(64), s + F32(1), F32(0)).astype(F32)
    return first


@pytest.mark.parametrize("version", ["v3", "v2"])
def test_replay_takes_the_closed_form_on_the_cycle(version):
    """v3's and v2's replay walks no subgroup by ticks for an entry step on
    the cycle (-0.0 and 0..64), and walks p over at most 65 ticks; an entry
    step off it walks subgroups by ticks exactly until one starts on the
    cycle (every one for a stuck counter), at B=4096, every segment start."""
    sub, n = 64, 4096 // 64
    on = [-0.0] + [float(i) for i in range(65)]
    step = torch.tensor(on + list(ODD_STEPS), dtype=torch.float32)
    planes, _ = _planes(len(step), seed=5)
    first = _first_on_cycle(step, sub, n)
    assert (first[:len(on)] == 0).all()
    assert (first[np.isin(step.numpy(), [-2.0 ** 25, -1e9, -np.inf])]
            == n).all()
    reps = _replays_v32(version, planes, step, list(range(n)), sub)
    for K, (_, info) in reps.items():
        assert np.array_equal(info["walked"].numpy(), np.minimum(first, K))
        p_ticks = info["p_ticks"].numpy()
        assert (p_ticks[first <= K] <= 65).all()
        assert (p_ticks[first > K] == 0).all()
        if K >= 2:   # a wrap falls in every 65 ticks on the cycle
            assert info["from_wrap"][:len(on)].all()


def _rows_v2_in_place(tgt, D, p, s, mult, sub, j_idx):
    """The kernel's v2 subgroup (``csrc/additive.cu``): its per-tick selects
    switch (tgt, D) to the next cycle's in place at the wrap tick, with no
    wrapped flag."""
    tgtm = tgt * mult
    D2 = tgt - tgtm
    ps, tgts, Ds = [], [], []
    for _ in range(sub):
        wrap = s == 0.0
        p = torch.where(wrap, C, p * (1.0 - (s + 1.0) / 64.0))
        s = torch.where(s < 64.0, s + 1.0, 0.0)
        tgt = torch.where(wrap, tgtm, tgt)
        D = torch.where(wrap, D2, D)
        ps.append(p)
        tgts.append(tgt)
        Ds.append(D)
    amp = torch.stack(tgts) + torch.stack(Ds) * torch.stack(ps)[:, None, :]
    return amp, tgt, D, p, s


@pytest.mark.parametrize("steps", ["cycle", "odd"])
@pytest.mark.parametrize("B", [64, 1024, 4096])
def test_v2_switches_in_place(steps, B):
    """Two wraps are 65 ticks apart for any entry step, so a subgroup of at
    most 64 ticks holds one at most, and the kernel's v2 body, which
    switches (tgt, D) in place at the wrap tick, equals ``plain_v2`` bit
    for bit (NaN equal to NaN): rows, state and the last tick's amp."""
    values = STEPS if steps == "cycle" else ODD_STEPS
    planes, _ = _planes(len(values), seed=7)
    step = torch.tensor(values, dtype=torch.float32)
    sub = tadd.subgroup_len(B, "v2")
    got = tadd._plain_closed(_rows_v2_in_place, *planes, step, B, sub,
                             False)
    want = tadd.plain_v2(*planes, step, B, sub)
    for a, b in zip(got, want):
        assert _same(a, b)


# ------------------------------------------------------------------ #
# K2, the exact-op-order kernel: its segments' replay_parity()
# ------------------------------------------------------------------ #
def _parity_tick(cur, tgt, s, mult):
    """``plain_parity``'s envelope tick (its ops, in its order)."""
    tgt = torch.where(s == 0.0, cur * mult, tgt)
    interp = s < 64.0
    tau = (s + 1.0) / 64.0
    c_i = cur * (1.0 - tau) + tgt * tau
    return (torch.where(interp, c_i, tgt), tgt,
            torch.where(interp, s + 1.0, 0.0))


def _replay_parity(planes, step, T):
    """``replay_parity()`` of csrc/additive.cu on whole planes: the state
    at tick T.  (a) while the step is off its integer cycle 0..64, the
    body's ticks one at a time, or, where 8 fit before T and s + 8 < 0, 8
    ticks as the blend and s + 1 alone, (b) on the cycle: the first wrap
    tick (s = 64) at t + 64 - s, one ``tgt * mult`` per 65 ticks after it,
    and the body's ticks after the last wrap, (c) the rotation over all T
    ticks.  ``info``: per voice the ticks walked off the cycle
    (``walked``, T for a voice that never reaches it), the cycles stepped
    by a product (``cycles``) and the ticks walked after the last wrap
    (``tail``), and whether a wrap came before T (``wrapped``)."""
    zr, zi, mr, mi, cur, tgt, mult = planes
    s = step.clone()
    for _ in range(T):
        zr, zi = zr * mr - zi * mi, zr * mi + zi * mr
    walking = ~_on_cycle(s)
    walked = torch.zeros(s.shape, dtype=torch.int64)
    blend_left = torch.zeros(s.shape, dtype=torch.int64)   # of an 8-tick run
    for t in range(T):
        # where no 8-tick run is under way, the kernel checks its loops'
        # conditions: a new run, or one tick while off the cycle
        free = walking & (blend_left == 0)
        blend_left = torch.where(free & (t + 8 <= T) & (s + 8.0 < 0.0), 8,
                                 blend_left)
        walking = walking & ((blend_left > 0) | ~_on_cycle(s))
        if not bool(walking.any()):
            break
        blend = walking & (blend_left > 0)
        c2, g2, s2 = _parity_tick(cur, tgt, s, mult)
        tau = (s + 1.0) / 64.0
        c2 = torch.where(blend, cur * (1.0 - tau) + tgt * tau, c2)
        s2 = torch.where(blend, s + 1.0, s2)
        cur = torch.where(walking, c2, cur)
        tgt = torch.where(walking, g2, tgt)
        s = torch.where(walking, s2, s)
        blend_left = torch.where(blend, blend_left - 1, blend_left)
        walked = torch.where(walking, t + 1, walked)
    walking = walking & ~_on_cycle(s)
    on = ~walking
    wrap = walked + 64 - torch.where(on, s, 0.0).long()
    first = on & (wrap < T)
    tgt = torch.where(first & (s == 0.0), cur * mult, tgt)
    cycles = torch.where(first, (T - wrap - 1) // 65, 0)
    for k in range(int(cycles.max()) if T else 0):
        tgt = torch.where(first & (k < cycles), tgt * mult, tgt)
    cur = torch.where(first, tgt, cur)
    s = torch.where(first, 0.0, s)
    t_c = torch.where(first, wrap + 1 + 65 * cycles,
                      torch.where(on, walked, T))
    for t in range(int(t_c.min()) if T else 0, T):
        act = t >= t_c
        c2, g2, s2 = _parity_tick(cur, tgt, s, mult)
        cur = torch.where(act, c2, cur)
        tgt = torch.where(act, g2, tgt)
        s = torch.where(act, s2, s)
    return (zr, zi, cur, tgt, s), {"walked": walked, "cycles": cycles,
                                   "tail": T - t_c, "wrapped": first}


def _segmented_parity(planes, step, B, S):
    """K2 in S time segments: each replays its start, then runs
    ``plain_parity``'s body over its B / S ticks.  Returns (rows [B, V],
    the last segment's state, whether some replay passes a wrap)."""
    n = B // S
    ys, passed = [], False
    for seg in range(S):
        (zr, zi, cur, tgt, s), info = _replay_parity(planes, step, seg * n)
        passed |= bool(info["wrapped"].any())
        y, *state = tadd.plain_parity(zr, zi, planes[2], planes[3], cur, tgt,
                                      planes[6], s, n)
        ys.append(y)
    return torch.cat(ys), state, passed


_PLAIN_PARITY = {}


def _plain_parity(planes, step, B, key):
    if (key, B) not in _PLAIN_PARITY:
        _PLAIN_PARITY[(key, B)] = tadd.plain_parity(*planes, step, B)
    return _PLAIN_PARITY[(key, B)]


# ODD_STEPS and steps far below 0 that reach the cycle late or never
# (the kernel walks 8 ticks at a time with the blend alone while s + 8 <
# 0): -2^24 - 2 steps by 2, then 1, and stays below 0 for 2^24 ticks
PARITY_STEPS = ODD_STEPS + (-1000.0, -100.5, -9.0, -8.5, -7.5,
                            -2.0 ** 24 - 2)
# every segment count the harmonic-sum chunks (N = 32 samples) and the
# mix's 8-bit ticket fields allow: S <= 4 dividing B / N
PARITY_CASES = [(B, S) for B in (64, 256, 1024, 4096) for S in (1, 2, 4)
                if (B // tadd.subgroup_len(B, "parity")) % S == 0]


@pytest.mark.parametrize("B,S", PARITY_CASES)
def test_parity_segments_equal_the_plain_version(B, S):
    """K2's segments with the entry steps 0, 1, 63, 64 among the voices
    equal ``plain_parity`` in one piece, bit for bit: the rows, the state
    planes and the voice mix in the kernel's order; from B=256 on some
    replay passes a wrap."""
    planes, step = _planes()
    y, state, passed = _segmented_parity(planes, step, B, S)
    y_p, *state_p = _plain_parity(planes, step, B, "cycle")
    assert torch.equal(y, y_p)
    for a, b in zip(state, state_p):
        assert torch.equal(a, b)
    assert torch.equal(_kernel_mix(y), _kernel_mix(y_p))
    if S > 1 and B >= 256:
        assert passed


@pytest.mark.parametrize("B,S", PARITY_CASES)
def test_parity_segments_for_entry_steps_outside_0_64(B, S):
    """Entry steps the envelope never produces (``PARITY_STEPS``:
    fractions, negatives down to -2^24 - 2, steps above 64, -0.0, a
    denormal, 2^24, stuck counters, +-inf, NaN): K2's segments still equal
    ``plain_parity`` in one piece, NaN equal to NaN, the rows, the state
    and the mix in the kernel's order."""
    planes, _ = _planes(len(PARITY_STEPS), seed=3)
    step = torch.tensor(PARITY_STEPS, dtype=torch.float32)
    y, state, _ = _segmented_parity(planes, step, B, S)
    y_1, *state_1 = _plain_parity(planes, step, B, "odd")
    assert _same(y, y_1)
    for a, b in zip(state, state_1):
        assert _same(a, b)
    assert _same(_kernel_mix(y), _kernel_mix(y_1))


def _first_on_cycle_tick(step, T):
    """Per voice, the first tick whose step is an integer in 0..64, by the
    body's step ops in float32 (T if none before it)."""
    s = step.numpy().astype(F32)
    first = np.full(s.shape, T)
    with np.errstate(invalid="ignore"):
        for t in range(T + 1):
            on = (s == np.floor(s)) & (s >= 0) & (s <= 64)
            first = np.where(on & (first == T), t, first)
            s = np.where(s < F32(64), s + F32(1), F32(0)).astype(F32)
    return np.minimum(first, T)


@pytest.mark.parametrize("T", [1, 64, 65, 130, 1024, 3072])
def test_parity_replay_steps_the_cycle(T):
    """A voice on the step's cycle (-0.0 and 0..64) walks no tick of the
    envelope before its wrap: it steps ``tgt * mult`` once per 65 ticks
    after the first wrap tick (64 - s) and walks at most 64 ticks after
    the last; a voice off the cycle walks ticks up to the first whose
    step is an integer in 0..64 (all T for a stuck counter).  The
    replayed state equals ``plain_parity``'s after T ticks, NaN equal to
    NaN."""
    on = [-0.0] + [float(i) for i in range(65)]
    step = torch.tensor(on + list(PARITY_STEPS), dtype=torch.float32)
    planes, _ = _planes(len(step), seed=5)
    state, info = _replay_parity(planes, step, T)
    n_on = len(on)
    assert np.array_equal(info["walked"].numpy(),
                          _first_on_cycle_tick(step, T))
    s0 = np.asarray([0.0] + on[1:])
    wrap = 64 - s0
    passed = wrap < T
    want_cycles = np.where(passed, (T - wrap - 1) // 65, 0)
    want_tail = np.where(passed, (T - wrap - 1) % 65, T)
    assert np.array_equal(info["cycles"][:n_on].numpy(), want_cycles)
    assert np.array_equal(info["tail"][:n_on].numpy(), want_tail)
    assert int(info["tail"][:n_on].max()) <= 64
    stuck = np.isin(step.numpy(), [-2.0 ** 25, -1e9, -np.inf])
    assert (info["walked"].numpy()[stuck] == T).all()
    _, zr, zi, cur, tgt, s = tadd.plain_parity(*planes, step, T)
    for a, b in zip(state, (zr, zi, cur, tgt, s)):
        assert _same(a, b)
