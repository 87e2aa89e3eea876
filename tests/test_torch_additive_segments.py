"""K1's time segments, modelled in PyTorch on the CPU: each voice's block
split at subgroup boundaries into S segments, each segment starting from
the state ``csrc/additive.cu``'s ``replay()`` rebuilds (the oscillator
rotated by ``m^SUB`` and the cycle's ``(tgt, D)`` over the subgroups before
it; v3 and v2 walk their step counter and envelope product ``p`` tick by
tick, v4 steps its counter per subgroup and replays ``p`` tick by tick
from the last subgroup whose wrap tick resets it).

Held ``torch.equal`` to the plain versions ``plain_v4``, ``plain_v3`` and
``plain_v2`` run in one piece: the per-voice rows of every tick, the state
planes after the block, and the voice mix summed in the kernel's order
(two warps per block in warp order, groups of 16 blocks in block order,
then the groups in order) from either's rows.  B in {64, 256, 1024, 4096}
(one to 64 subgroups of 64 ticks), S in {1, 2, 4, 8, 16} where S divides
the subgroups, and the entry steps 0, 1, 63 and 64 among the voices; a
segment's replay window holds a wrap for every B >= 256.  Entry steps
outside 0..64 (0.5, 64.5, 70, -3) too: the replay is the kernel's own ops,
so the segments equal one piece for any input.  The segment count the
card picks is tested there (``tests/test_torch_cuda.py``).
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


def _replay(version, planes, step, K, sub):
    """replay() of csrc/additive.cu on whole planes: the state at the start
    of subgroup K; also whether some voice's window starts at a wrap."""
    zr, zi, mr, mi, cur, tgt_in, mult = planes
    msr, msi = mr, mi
    for _ in range(sub - 1):
        msr, msi = msr * mr - msi * mi, msr * mi + msi * mr
    s = step.clone()
    tgt = torch.where(s == 0.0, cur, tgt_in)
    D = cur - tgt
    p = torch.ones_like(s)
    if version != "v4":   # v3, v2: their own loop without the sums
        any_wrap = False
        for _ in range(K):
            tgtm = tgt * mult
            G1 = tgtm - tgt
            D2 = tgt - tgtm
            wrapped = torch.zeros_like(s, dtype=torch.bool)
            for _ in range(sub):
                wrap = s == 0.0
                wrapped = wrapped | wrap
                p = torch.where(wrap, C, p * (1.0 - (s + 1.0) / 64.0))
                s = torch.where(s < 64.0, s + 1.0, 0.0)
            zr, zi = zr * msr - zi * msi, zr * msi + zi * msr
            tgt = torch.where(wrapped, tgtm, tgt)
            D = torch.where(wrapped, D2 if version == "v2" else -G1, D)
            any_wrap |= bool(wrapped.any())
        return (zr, zi, tgt, D, s, p), any_wrap
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
    for seg in range(S):
        state, wrapped = _replay(version, planes, step, seg * n, sub)
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


@pytest.mark.parametrize("version", ["v4", "v3", "v2"])
@pytest.mark.parametrize("B,S", [(1024, 4), (4096, 16)])
def test_segments_equal_one_piece_for_entry_steps_outside_0_64(version, B,
                                                                S):
    """An entry step the envelope never produces (0.5, 64.5, 70, -3): the
    segments still equal the version in one piece, bit for bit."""
    planes, _ = _planes(4, seed=3)
    step = torch.tensor([0.5, 64.5, 70.0, -3.0])
    y, state, _ = _segmented(version, planes, step, B, S)
    y_1, *state_1 = tadd._CLOSED[version](
        *planes, step, B, tadd.subgroup_len(B, version))
    assert torch.equal(y, y_1)
    for a, b in zip(state, state_1):
        assert torch.equal(a, b)
