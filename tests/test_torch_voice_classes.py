"""Voice-capacity classes in the port (``utils/voice_classes.py``).

- The two schedules of ``tests/test_voice_classes.py``, the port against
  the JAX package's ``VoiceClassHost``: the same capacity after every
  block, the same switch count, the audio within the JAX package's own
  v4-against-composed bound (on the CPU the port's steady blocks run the
  fused v4 closed forms, the JAX package's its composed voice; the
  full-capacity graphs sit 2.8e-4 apart on the 40-block schedule), and
  the classes moving the two packages no further apart than that, within
  1e-4.
- A class left and entered again: the destination variant's host caches
  are cleared on every switch, so the port equals its full-capacity graph
  up to the dropped release tails (the JAX package keeps those caches and
  is off by 3-4 from the up-switch on).
- Every block's staging, cached or fresh, equals a prepass recomputed
  from the same host state with the host caches cleared.
"""

import copy

import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.models.electric_piano import build_electric_piano as jbuild
from oscen_tpu.utils.voice_classes import VoiceClassHost as JHost
from oscen_tpu_torch.models.electric_piano import build_electric_piano as tbuild
from oscen_tpu_torch.utils.voice_classes import VoiceClassHost as THost

SR = 48000.0
B = 512
# the JAX package's bound between its fused v4 kernel and its composed
# voice (tests/test_electric_piano.py:317-323)
V4_VS_COMPOSED = 5e-4


def _schedule(pkg, target, blocks):
    """tests/test_voice_classes.py's: 4 notes, released at block 3, 12
    more 8 blocks before the end; the capacity after every block."""
    out, caps = [], []
    for i in range(blocks):
        evs = []
        if i == 0:
            evs = [[0x90, 60 + j, 100] for j in range(4)]
        elif i == 3:
            evs = [[0x80, 60 + j, 0] for j in range(4)]
        elif i == blocks - 8:
            evs = [[0x90, 40 + j, 90] for j in range(12)]
        for e in evs:
            target.queue_event("midi_in", 0, pkg.raw_midi_event(e))
        out.append(np.asarray(target.process_block()["out"]))
        caps.append(getattr(target, "active_cap", None))
    return np.concatenate(out), caps


def _hosts(caps, tail):
    kw = dict(capacities=caps, sample_rate=SR, block_size=B, mode="block",
              tail_seconds=tail)
    return JHost(jbuild, **kw), THost(tbuild, device="cpu", **kw)


def _match_full_capacity(blocks):
    jv, tv = _hosts((8, 16), 0.25)
    a, jcaps = _schedule(J, jv, blocks)
    b, tcaps = _schedule(T, tv, blocks)
    assert tcaps == jcaps
    assert tv.switches == jv.switches >= 2
    r, _ = _schedule(T, tbuild(16).compile(SR, block_size=B, device="cpu"),
                     blocks)
    assert np.abs(a).max() > 0.01
    # the JAX test's bound: the dropped sub-audible release tails
    assert np.abs(r - b).max() < 2e-3
    np.testing.assert_allclose(b, a, atol=V4_VS_COMPOSED, rtol=0)
    jr, _ = _schedule(J, jbuild(16).compile(SR, block_size=B), blocks)
    # the classes move the two packages no further apart than their
    # full-capacity graphs are
    np.testing.assert_allclose(b - a, r - jr, atol=1e-4, rtol=0)


@pytest.mark.slow  # the JAX side takes >10 s on a CPU, as in JAX's test
def test_voice_classes_match_full_capacity():
    _match_full_capacity(40)


def test_voice_classes_match_full_capacity_short():
    """The same schedule over 12 blocks (down-switch after block 0,
    up-switch before block 4)."""
    _match_full_capacity(12)


def test_voice_classes_steal_semantics_preserved():
    """Striking more notes than the small class holds up-switches BEFORE
    the block, so no premature stealing happens; as in JAX."""
    jv, tv = _hosts((4, 16), 0.1)
    outs = []
    for pkg, vc in ((J, jv), (T, tv)):
        vc.process_block()
        assert vc.active_cap == 4
        for j in range(10):
            vc.queue_event("midi_in", 0,
                           pkg.raw_midi_event([0x90, 50 + j, 100]))
        outs.append(np.asarray(vc.process_block()["out"]))
        assert vc.active_cap == 16
        assert sum(vc._alloc(16).busy_mask(10**9)) == 10
        assert np.isfinite(outs[-1]).all()
    assert tv.switches == jv.switches == 2
    np.testing.assert_allclose(outs[1], outs[0], atol=V4_VS_COMPOSED, rtol=0)


# --------------------------------------------------------------------- #
# the staging of every block against a prepass from scratch
# --------------------------------------------------------------------- #
def _host_snapshot(c):
    """Everything a prepass and its staging read or advance on the host
    (the set ``CompiledGraph.explain`` saves)."""
    hosts = {}
    for name in c.prog.host_nodes:
        nodes = ([c.ir.nodes[name].node] if c.ir.nodes[name].count == 1
                 else c.prog.host_instances[name])
        hosts[name] = [copy.deepcopy(n.__dict__) for n in nodes]
    return (hosts, {k: list(q) for k, q in c._event_queues.items()},
            copy.deepcopy(c._params), copy.deepcopy(c._host_steady),
            c._last_event_outs)


def _host_restore(c, snap):
    hosts, queues, params, steady, ev_outs = snap
    for name, saved in hosts.items():
        nodes = ([c.ir.nodes[name].node] if c.ir.nodes[name].count == 1
                 else c.prog.host_instances[name])
        for n, s in zip(nodes, copy.deepcopy(saved)):
            n.__dict__.update(s)
    for k, evs in queues.items():
        c._event_queues[k][:] = evs
    c._params = copy.deepcopy(params)
    c._host_steady = copy.deepcopy(steady)
    c._last_event_outs = ev_outs


def _same_staging(x, y):
    (pa, ea), (pb, eb) = x.unpack(), y.unpack()
    assert sorted(pa) == sorted(pb) and sorted(ea) == sorted(eb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    for k in ea:
        for f in ("offsets", "values", "valid"):
            assert torch.equal(getattr(ea[k], f), getattr(eb[k], f)), (k, f)


class StagingCheck:
    """Wraps a compiled graph's staging: every block's staging (the cached
    one of a steady block too) is compared with the staging of a prepass
    run from the same host state with ``_host_steady`` cleared; the host
    state is then put back as the block left it.  Counts the blocks
    checked."""

    def __init__(self, c):
        self.c, self.checked = c, 0
        self._stage, self._run = c._stage, c._run_block
        self._pending, self._fresh_block = None, False
        c._host_prepass = self._prepass(c._host_prepass)
        c._stage = self._staged
        c._run_block = self._block

    def _fresh(self, B, snap):
        c = self.c
        after = _host_snapshot(c)
        _host_restore(c, snap)
        c._host_steady = {}
        ev, hv = self._orig_prepass(B)
        fresh = self._stage(B, ev, hv)
        _host_restore(c, after)
        return fresh

    def _prepass(self, orig):
        self._orig_prepass = orig

        def wrapped(B):
            self._pending = _host_snapshot(self.c)
            return orig(B)
        return wrapped

    def _staged(self, B, ev, hv, stream_inputs=None):
        staged = self._stage(B, ev, hv, stream_inputs)
        _same_staging(staged, self._fresh(B, self._pending))
        self._pending, self._fresh_block = None, True
        self.checked += 1
        return staged

    def _block(self, B, staging, **how):
        if self._fresh_block:
            self._fresh_block = False
        else:
            # a steady block on its cached staging
            _same_staging(staging, self._fresh(B, _host_snapshot(self.c)))
            self.checked += 1
        return self._run(B, staging, **how)


def _reentry(target, blocks=24):
    """Ten notes struck and released, a down-switch to 4 voices at block
    5, 2 notes at block 10, 8 more at block 14 (an up-switch back to 16).
    A note-off of an unheld key on every block runs the prepass."""
    out, caps = [], []
    for i in range(blocks):
        evs = []
        if i == 0:
            evs = [[0x90, 50 + j, 100] for j in range(10)]
        elif i == 1:
            evs = [[0x80, 50 + j, 0] for j in range(10)]
        elif i == 10:
            evs = [[0x90, 70 + j, 100] for j in range(2)]
        elif i == 14:
            evs = [[0x90, 80 + j, 100] for j in range(8)]
        for e in evs:
            target.queue_event("midi_in", 0, T.raw_midi_event(e))
        target.queue_event("midi_in", 0, T.raw_midi_event([0x80, 20, 0]))
        out.append(target.process_block()["out"].numpy())
        caps.append(getattr(target, "active_cap", None))
    return np.stack(out), caps


def test_reentered_class_plays_fresh_controls():
    """The port equals its 16-voice graph from the up-switch on, up to the
    release tails dropped at the down-switch (decaying from 0.23); with
    the destination's host caches kept it would be off by 3-4 there."""
    vc = THost(tbuild, capacities=(4, 16), sample_rate=SR, block_size=B,
               tail_seconds=0.05, device="cpu")
    checks = [StagingCheck(c) for c in vc.variants.values()]
    b, caps = _reentry(vc)
    r, _ = _reentry(tbuild(16).compile(SR, block_size=B, device="cpu"))
    assert caps == [16] * 5 + [4] * 9 + [16] * 10
    assert vc.switches == 2
    assert sum(ch.checked for ch in checks) == 24
    d = np.abs(b - r).max(axis=(1, 2))
    assert np.abs(r).max() > 10.0
    assert d[:6].max() == 0.0            # before the dropped tails
    assert 0.01 < d[6] < 0.3             # the dropped tails
    # after the up-switch only the dropped tails differ: below their
    # level at the block before the switch, and decaying
    assert d[14:].max() <= d[13] < 0.02
    assert d[-1] < 1e-3


def test_steady_and_event_blocks_stage_like_a_fresh_prepass():
    """The 40-block schedule's down- and up-switch with every block's
    staging checked (steady blocks reuse theirs)."""
    vc = THost(tbuild, capacities=(8, 16), sample_rate=SR, block_size=B,
               tail_seconds=0.25, device="cpu")
    checks = [StagingCheck(c) for c in vc.variants.values()]
    _, caps = _schedule(T, vc, 14)
    assert caps == [8] * 6 + [16] * 8
    assert sum(ch.checked for ch in checks) == 14


def test_switch_keeps_non_voice_mirrors_and_refuses_voice_mirrors():
    """A voice-array node with a host mirror cannot be permuted: refused
    at construction.  The piano has none."""
    from oscen_tpu_torch import Convolver, Graph, VoiceAllocator

    def build(n):
        g = Graph("Mirrored")
        g.input("midi_in", "event")
        g.output("out", "stream")
        g.add("alloc", VoiceAllocator(n))
        cv = g.add("cv", Convolver(max_ir_len=64), count=n)
        g.connect(cv.output, "out")
        return g
    with pytest.raises(ValueError, match="host mirror"):
        THost(build, capacities=(2, 4), block_size=64, device="cpu")
