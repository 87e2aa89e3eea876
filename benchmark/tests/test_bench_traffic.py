"""The traffic generator: the same seed gives the same messages and
another seed other ones, the ``perform`` mix's rate, offsets, keys,
velocities and durations are as its file states, and the ``held`` mix is
one chord."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.traffic import NOTE_OFF, NOTE_ON, Traffic

DATA = Path(__file__).resolve().parents[1] / "traffic"
SR = 48000.0


def mix(name):
    return json.loads((DATA / f"{name}.json").read_text())


def blocks(t, n):
    return [t.block(i) for i in range(n)]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**63 + 5, -3])
def test_perform_is_deterministic_from_the_seed(seed):
    a = blocks(Traffic(mix("perform"), seed, SR, 256), 300)
    b = blocks(Traffic(mix("perform"), seed, SR, 256), 300)
    c = blocks(Traffic(mix("perform"), seed + 1, SR, 256), 300)
    assert a == b
    assert a != c


def test_a_block_asked_again_is_the_same():
    t = Traffic(mix("perform"), 5, SR, 256)
    first = blocks(t, 500)
    assert blocks(t, 500) == first


def test_perform_rate_offsets_and_ranges():
    m = mix("perform")
    t = Traffic(m, 123456789, SR, 256)
    n = 6000                                  # 128 s of audio
    ons, offs = [], []
    for i in range(n):
        for off, status, note, vel in t.block(i):
            assert 0 <= off < m["block_size"]
            if status == NOTE_ON:
                assert 21 <= note <= 108 and 1 <= vel <= 127
                ons.append((i * m["block_size"] + off, note, vel))
            else:
                assert status == NOTE_OFF and vel == 0
                offs.append(i * m["block_size"] + off)
    seconds = n * m["block_size"] / SR
    rate = len(ons) / seconds
    # Poisson: the count's sd is sqrt(160 * 128) ~ 143 of ~20500 (0.7%)
    assert abs(rate - m["note_ons_per_s"]) < 0.03 * m["note_ons_per_s"]
    # offsets spread over the block, not bunched at its start
    pos = np.array([o % m["block_size"] for o, _, _ in ons])
    assert 0.4 < pos.mean() / m["block_size"] < 0.6
    keys = np.array([k for _, k, _ in ons])
    vels = np.array([v for _, _, v in ons])
    assert abs(keys.mean() - 64) < 1.0 and 11 < keys.std() < 13
    assert abs(vels.mean() - 64) < 1.5 and 15 < vels.std() < 19
    # every note-off follows its note-on within the cap
    assert len(offs) <= len(ons)
    assert len(offs) > 0.98 * len(ons)


def test_perform_durations_are_lognormal_and_capped():
    # a sparse copy of the mix, so that a key's notes rarely overlap and a
    # note-off pairs with its note-on by key
    m = {**mix("perform"), "note_ons_per_s": 2.0}
    t = Traffic(m, 99, SR, 256)
    n = int(900 * SR / m["block_size"])
    starts = {}
    durs = []
    for i in range(n):
        for off, status, note, _ in t.block(i):
            s = i * m["block_size"] + off
            if status == NOTE_ON:
                starts.setdefault(note, []).append(s)
            elif starts.get(note):
                durs.append((s - starts[note].pop(0)) / SR)
    durs = np.array(durs)
    assert durs.max() <= m["duration_s"]["max"] + 1 / SR
    assert len(durs) > 1500
    assert abs(np.median(durs) - m["duration_s"]["median"]) < 0.04
    # lognormal sigma 0.8: the quartiles at median * exp(-+0.54)
    q1, q3 = np.quantile(durs, [0.25, 0.75])
    assert abs(np.log(q3 / q1) / 2 - 0.8 * 0.6745) < 0.08


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_each_seed_draws_its_own_note_times(seed):
    """The seed draws the note-ons' times, not only their keys and
    velocities."""
    m = mix("perform")
    times = [[(i, off) for i in range(400)
              for off, st, _, _ in Traffic(m, s, SR, 256).block(i)
              if st == NOTE_ON] for s in (seed, seed + 1)]
    assert len(set(times[0]) & set(times[1])) < 0.05 * len(times[0])


def test_held_is_one_chord_of_every_voice():
    m = mix("held")
    t = Traffic(m, 42, SR, 256)
    b0 = t.block(0)
    assert len(b0) == 256
    assert [n for _, _, n, _ in b0] == [36 + i % 64 for i in range(256)]
    assert all(off == 0 and st == NOTE_ON and v == 100
               for off, st, _, v in b0)
    assert all(t.block(i) == [] for i in range(1, 200))
    assert t.warmup_blocks >= 3
