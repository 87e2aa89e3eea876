"""Sample-mode blocks replayed (``jit=True``, ``oscen_tpu_torch/graph/capture.py``)
on the CPU, where a replay calls the sample-mode block function (all B
per-sample steps) on the capture's static buffers: every line of the
protocol but the CUDA capture itself.

- The sample-mode models of ``tests/test_torch_sample_mode.py`` at 8
  voices: the piano, poly, fm and pivot synths, the README synth, the echo
  with audio staged every block, the 4x saturator under ``sinc`` and
  ``sinc_iir``, the twin peaks and the ``via=24`` island, at B=64 (and 256
  for the cheaper graphs).  One schedule each: a chord, steady blocks, a
  ``set_value``, a ramp, events at the same offsets for several blocks,
  then events at new offsets (every block with events eager as
  ``sample_events``), a change of B, ``render_steady`` and
  ``steady_checksum``.
- ``jit=True`` against ``jit=False``: ``torch.equal`` on every output, on
  the checksum and on the state; the replays counted, every eager block a
  key's warm-up or a block with events, no ``sample_mode`` reason left in
  ``eager_why``.
- The replays against the JAX package's jitted sample mode (one
  ``lax.scan`` a block) at the bounds ``tests/test_torch_sample_mode.py``
  pins: 1e-5 for the poly, fm and README synths and the pivot, 1e-4 for the
  piano, 1e-6 for the filters, echo, saturators and island.
"""

import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.models import electric_piano as jep
from oscen_tpu.models import fm_synth as jfm
from oscen_tpu.models import pivot as jpv
from oscen_tpu.models import poly_synth as jpoly
from oscen_tpu.models import simple as jsimple
from oscen_tpu.models import twin_peaks as jtp
from oscen_tpu_torch.graph.capture import EAGER_REASONS, tree_sig
from oscen_tpu_torch.graph.node import tree_map
from oscen_tpu_torch.models import electric_piano as tep
from oscen_tpu_torch.models import fm_synth as tfm
from oscen_tpu_torch.models import pivot as tpv
from oscen_tpu_torch.models import poly_synth as tpoly
from oscen_tpu_torch.models import simple as tsimple
from oscen_tpu_torch.models import twin_peaks as ttp
from test_torch_sample_mode import _readme, _sat_iir, _via_island

SR = 48000.0
VOICES = 8
X = (np.random.default_rng(7).standard_normal(64 * 256) * 0.3
     ).astype(np.float32)
# blocks of the schedule at the compiled B (then 2 at B // 2)
SET, RAMP, SAME, NEW, BLOCKS = 3, 5, 8, 12, 13
SAME_BLOCKS = range(SAME, NEW)


def _pick(mod_j, mod_t, fn, *args):
    return lambda p: getattr(mod_j if p is J else mod_t, fn)(*args)


# (id, build(pkg), B values, output, stream input or None, set_value,
# ramp, midi, atol against JAX)
MODELS = [
    ("piano", _pick(jep, tep, "build_electric_piano", VOICES), (64,), "out",
     None, ("brightness", 45.0), ("vibrato_intensity", 0.6), True, 1e-4),
    ("poly_synth", _pick(jpoly, tpoly, "build_poly_synth", VOICES), (64,),
     "audio_out", None, ("cutoff", 1800.0), ("resonance", 0.5), True, 1e-5),
    ("fm_synth", _pick(jfm, tfm, "build_fm_synth", VOICES), (64,),
     "audio_out", None, ("filter_cutoff", 1500.0), ("route", 0.5), True,
     1e-5),
    ("pivot", _pick(jpv, tpv, "build_pivot", VOICES), (64,), "audio_out",
     None, ("cutoff", 2500.0), ("cutoff", 3000.0), True, 1e-5),
    ("readme_synth", _readme, (64, 256), "audio_out", None, ("cutoff", 900.0),
     ("carrier_freq", 330.0), False, 1e-5),
    ("echo", _pick(jsimple, tsimple, "build_simple_echo", 0.02, SR),
     (64, 256), "out", "x", ("feedback", 0.6), ("mix", 0.8), False, 1e-6),
    ("saturator_sinc", _pick(jsimple, tsimple, "build_saturator", 4), (64,),
     "audio_out", None, None, None, False, 1e-6),
    ("saturator_sinc_iir", _sat_iir, (64,), "audio_out", None, None, None,
     False, 1e-6),
    ("twin_peaks", _pick(jtp, ttp, "build_twin_peaks"), (64, 256),
     "audio_out", "audio_in", ("resonance", 0.8), ("cutoff_a", 640.0), False,
     1e-6),
    ("via24_island", _via_island, (64, 256), "out", "x", None, None, False,
     1e-6),
]
CASES = [(m, B) for m in MODELS for B in m[2]]
IDS = [f"{m[0]}-B{B}" for m, B in CASES]


def _midi(c, pkg, i, B):
    """Block ``i``'s MIDI: the chord at block 0; a note-off and a note-on
    of one key at the same offsets in every block of ``SAME_BLOCKS``; at
    ``NEW`` the same two at other offsets."""
    if i == 0:
        for n, off in ((60, 0), (64, 10), (67, 30)):
            c.queue_event("midi_in", off, pkg.raw_midi_event([0x90, n, 100]))
    elif i in SAME_BLOCKS or i == NEW:
        key = 48 + i % VOICES
        offs = (3, B // 2 + 1) if i < NEW else (7, B // 2 + 9)
        c.queue_event("midi_in", offs[0], pkg.raw_midi_event([0x80, key, 0]))
        c.queue_event("midi_in", offs[1],
                      pkg.raw_midi_event([0x90, key, 90]))


def _schedule(pkg, case, B, jit=True):
    """The schedule on a sample-mode graph of ``pkg``: the outputs of every
    block, of ``render_steady(3)`` and ``steady_checksum(3)``; and the
    graph."""
    _, build, _, out, stream, setv, ramp, midi, _ = case
    kw = {"device": "cpu", "jit": jit} if pkg is T else {}
    # a JAX block's output is read before the next block is staged: the
    # JAX package's host prepass reuses its numpy arrays, which a block
    # still queued on the CPU backend may read
    own = (lambda y: y) if pkg is T else np.asarray
    c = build(pkg).compile(SR, block_size=B, mode="sample", **kw)
    outs = []
    pos = 0
    for i in range(BLOCKS + 2):
        n = B if i < BLOCKS else B // 2
        if midi:
            _midi(c, pkg, i, B)
        if i == SET and setv:
            c.set_value(*setv)
        if i == RAMP and ramp:
            c.set_value_with_ramp(ramp[0], ramp[1], int(2.5 * B))
        si = {stream: X[pos:pos + n]} if stream else None
        pos += n
        outs.append(own(c.process_block(n, stream_inputs=si)[out]))
    outs.append(own(c.render_steady(3)[out]))
    outs.append(c.steady_checksum(3))
    return outs, c


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


@pytest.mark.parametrize("case,B", CASES, ids=IDS)
def test_sample_mode_replays_equal_eager(case, B):
    """``jit=True`` (replays) against ``jit=False`` from the same schedule:
    every output, the checksum and the final state equal bit for bit; the
    steady and ramp blocks after each key's warm-up replay, every block
    with events runs eagerly as ``sample_events``."""
    a, ca = _schedule(T, case, B, jit=True)
    b, cb = _schedule(T, case, B, jit=False)
    for x, y in zip(a[:-1], b[:-1]):
        assert torch.equal(x, y)
    assert a[-1] == b[-1]
    assert tree_sig(ca.state) == tree_sig(cb.state)
    assert all(torch.equal(x, y)
               for x, y in zip(_leaves(ca.state), _leaves(cb.state)))
    assert float(a[0].abs().max()) > 0.01
    n, why = ca.block_counts, ca.eager_why
    # BLOCKS + 2 blocks, 3 of render_steady and 3 of steady_checksum
    assert n["replayed"] + n["eager"] == cb.block_counts["eager"] \
        == BLOCKS + 2 + 6
    assert set(why) == set(EAGER_REASONS) and "sample_mode" not in why
    # the chord, the repeated and the new events
    assert why["sample_events"] == (2 + len(SAME_BLOCKS) if case[7] else 0)
    assert why["warmup"] + why["sample_events"] == n["eager"]
    assert why["jit_off"] == why["sharded"] == 0
    # render_steady and steady_checksum replay every block
    assert n["replayed"] >= 6
    # keys: steady at B and at B // 2, the ramp, and with a stream input
    # the steady key without it (render_steady stages none); a set_value
    # stays in the steady key: sample mode keys no literals
    assert why["warmup"] == 2 + (case[5] is not None) + (case[4] is not None)


@pytest.mark.parametrize("case,B", [c for c in CASES if c[1] == 64],
                         ids=[i for i, c in zip(IDS, CASES) if c[1] == 64])
def test_sample_mode_replays_match_jax_jitted(case, B):
    """The replayed schedule against the JAX package's jitted sample mode
    (its ``lax.scan`` per block, ``render_steady`` and ``steady_checksum``)
    at the bound ``tests/test_torch_sample_mode.py`` pins per model."""
    atol = case[-1]
    a, _ = _schedule(J, case, B)
    b, cb = _schedule(T, case, B)
    assert cb.block_counts["replayed"] >= 6
    for x, y in zip(a[:-1], b[:-1]):
        x = np.asarray(x)
        assert y.shape == x.shape
        np.testing.assert_allclose(y.numpy(), x, atol=atol, rtol=0)
    assert b[-1] == pytest.approx(a[-1], rel=1e-4, abs=1e-6)


def test_sample_mode_event_offsets_are_in_the_key():
    """A sample-mode block applies its events at the host slots, which a
    captured block would have to hold in its key.  Such a block runs
    eagerly whatever its offsets (``sample_events``), so no capture holds
    an offset: the steady blocks around repeated and new offsets replay
    the one steady capture, every block the eager answer."""
    case = MODELS[1]

    def run(jit):
        c = case[1](T).compile(SR, block_size=64, mode="sample",
                               device="cpu", jit=jit)
        ys = []
        for i, offs in enumerate((None, (5, 40), None, (5, 40), (5, 40),
                                  (9, 20), None, None)):
            if offs:
                key = 50 + i
                c.queue_event("midi_in", offs[0],
                              T.raw_midi_event([0x90, key, 90]))
                c.queue_event("midi_in", offs[1],
                              T.raw_midi_event([0x80, key, 0]))
            ys.append(c.process_block()["audio_out"])
        return ys, c
    a, ca = run(True)
    b, _ = run(False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # eager: block 0 (the steady key's warm-up) and the 4 blocks with
    # events; blocks 2, 6 and 7 replay one capture
    assert ca.block_counts == {"replayed": 3, "eager": 5, "captures": 1}
    assert ca.eager_why["sample_events"] == 4
    assert ca.eager_why["warmup"] == 1


@pytest.mark.parametrize("jit,device,backend,events,why", [
    (True, "cpu", None, True, "sample_events"),
    (True, "cuda", None, True, "sample_events"),
    (True, "cuda", "nccl", True, "sample_events"),
    (True, "cuda", None, False, None),
    (True, "cuda", "nccl", False, None),
    (False, "cuda", None, True, "jit_off"),
])
def test_sample_events_capture_decision(jit, device, backend, events, why):
    """What ``CompiledGraph._run_block`` asks before a block: a sample-mode
    block that carries events stays eager (``sample_events``) on the card
    and on the CPU, sharded or not; one without events is captured."""
    from oscen_tpu_torch.graph.capture import eager_reason
    assert eager_reason(jit, torch.device(device), backend,
                        sample_events=events) == why
