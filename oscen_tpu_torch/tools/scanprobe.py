"""Where the scans' and the additive voice's time goes, and the redesigns
against the old bodies, on the card.

    python -m oscen_tpu_torch.tools.scanprobe [--old DIR [--ablations]]

Three parts, one line per row:

- ``latency``: cycles per dependent step on one thread (``csrc/scanprobe.cu``
  ``lat_kernel``): FMUL + FADD, DFMA, the float32 -> float64 -> float32
  round trip with a DADD, a shared-memory load, DMUL, FADD + IEEE
  division, and K6's wraps: FADD -> FRND.FLOOR -> FADD (``p - floor(p)``),
  FADD -> FSETP -> FSEL -> FADD (``q + c``) and FADD -> (FSETP, FADD) ->
  FSEL (the select ``q >= 1 ? q - 1 : q``);
- ``probe``: the old bodies of ``phase_scan`` (K6), ``tpt_svf_scan`` (K7)
  and ``lp18_scan`` (K8) with one cost taken out at a time (dt or x from a
  register, the tanh as the identity, the division as a product with a
  hoisted reciprocal, other unrolls), row coefficients, at the main paths'
  shapes; K6's new ring with the reference's ``floor`` wrap instead of the
  short one (``probe_phase`` (c)) beside the shipped kernel, each first
  checked equal to the plain version;
  K1 (v4 with the mix) at 1, 2 and 4 time segments per voice (1: the
  register reduce-scatter alone), each first checked equal to the shipped
  body;
  K15 and K13 at V=256, B=1024 and 4096, dt as rows and per sample, as
  one warp per 32 lanes: the operators skewed by a sample with their
  inputs loaded inside the loop (the skew alone), in tick order on the
  staged ring (the ring alone), skewed by a sample on the ring (both),
  and op3 alone, the sine unrounded or the wraps left out (what one
  operator's chain and its FRNDs cost); beside the shipped kernel (a warp
  per operator, skewed by a chunk, on the ring), the exact ones first
  checked equal to the plain version;
  K9 (``biquad_scan``) at V=1 with per-sample planes (the IIR lowpass's
  lane) and V=256 with planes and rows, B=1024: its old body as is, with
  x and the coefficients from registers, without the snaps and both; on
  the staged ring (planes only) without snaps, with y stored by the chain
  warp, the shipped body's copy (y staged), the chain warp reading no
  shared memory and the producer copying nothing; K14
  (``fm_operator_scan``) at V=256, B=1024 and 4096: its old body as is,
  with the planes from registers, without the ``* lvl`` and both; on the
  ring with y stored, the shipped body's copy (y staged), the chain warp
  reading no shared memory and the producer copying nothing; beside the
  shipped kernels, the exact ones first checked equal to the plain
  version; the LDL / STL count of every shipped ``chain3_kernel``,
  ``allpass_kernel``, ``biquad_kernel`` and ``fm_operator_kernel``
  instance (built ``--fmad=false``) and their registers; K11
  (``adsr_scan``) at V=256, B=1024 in the decay, release, gate-on and
  sustained regimes, the shipped body beside ``ADSR_PROBES``' edits of it
  (scan_stage.cuh's ring depth; for timing only the level's chain cut,
  the release's quotient check left out, and the ring alone: a decaying
  chunk's body empty, then no copies, then the barriers alone);
- ``ab`` (with ``--old DIR``, a tree of the parent commit, e.g. unpacked
  by ``git archive``): that tree's ``csrc/iir.cu``, ``csrc/phase.cu``,
  ``csrc/additive.cu``, ``csrc/fm.cu`` and ``csrc/adsr.cu`` and the
  package's own, built
  alike, timed in turns (old, new, new, old) per window at the main paths'
  shapes: K7 V=256 at B=1024 and 4096 (row and per-sample coefficients)
  and V=1; K8 V=2 and 1, rows and a sweep; K6 V=256 at 1024 and 4096 steps
  and V=1 at 4096 and 16384 (the 4x saturator's lane at B=1024 and 4096);
  K1 v4 V=256 with the mix at B=1024 and 4096 and without it at 1024; K3
  (v3) and K4 (v2) at the same shapes, and without the mix at B=1024 and
  4096 with every voice off the step's cycle: stuck (-2^25, where s + 1
  == s: the replay walks every subgroup by ticks, as the parent's does)
  and off by 0.5 (-2.5 .. 63.5: it reaches the cycle within two
  subgroups); K10
  V=2 over 2048, 1024, 8192 and 4096 steps (the 4x IIR saturator's two
  halfband stages at B=1024 and 4096); K15 and K13 V=256 at B=1024 and
  4096, dt as rows and per sample; K9 V=1 with per-sample planes at
  B=1024 and 4096 and V=256 with rows and with planes at B=1024 and 4096;
  K14 V=256 at B=1024 and 4096; K2 (parity) V=256 at B=1024 and 4096,
  with and without the mix, every voice on the step's cycle or stuck
  (-2^25), the new body at 1, 2 and 4 time segments per voice (the
  explicit-count entry ``oscen_additive_closed_segs``, version 0) against
  the old one warp per voice; K12 (``fract_phase3``) V=256 at B=1024 and
  4096 on
  the models' lanes (p0 in [0, 1), dt in (0, 0.5): the short wrap), on
  lanes off it (p0 below 0) and on warps whose lanes disagree (both
  loops); K11 (``adsr_scan``) V=256 at B=1024 and 4096 in the regimes
  ``ADSR_AB`` names (``tools.adsr_regime``), beside the old and new
  ``adsr_kernel``'s SASS (LDL / STL, MUFU, FSEL, FMNMX) and registers; the
  run fails on LDL / STL in the new one.  Each row first checks that the new
  outputs equal the old build's on the same inputs (``torch.equal``, every
  output, NaN equal to NaN) and the plain version (the scans
  ``torch.equal``, K12 on the bit patterns; K1's, K2's, K3's and K4's
  state planes ``torch.equal``, y within the kernel's bound; the stuck
  rows' state planes equal with NaN equal to NaN, and without the mix y
  NaN where the plain version's is), and only then times.  The old
  ``additive.cu``'s local memory (LDL / STL in its SASS) is counted beside
  the new one's, for ``<64, 4>`` and for every ``<SUB, 3>`` and ``<SUB,
  2>`` instance with the registers ptxas gave ``<64, 3>`` and ``<64, 2>``;
  the run fails on LDL / STL in a new ``<SUB, 3>`` or ``<SUB, 2>``
  instance.  So are every ``additive_parity_kernel<N>`` instance's, with
  its FFMA (none with ``--fmad=false``; an IEEE division would bring its
  own, so none also says ``(s + 1) / 64`` is a product), and
  ``fract_phase3_kernel``'s, with its FRND and FSET, and ptxas's
  registers for both; the run fails on LDL / STL or FFMA in a new parity
  instance or LDL / STL in the new ``fract_phase3_kernel``.  Then the
  ablation kernels (``ab_ablations``; alone with ``--ablations``): every
  K16 body (``csrc/kabl.cu``, ``csrc/kabl_hmaj.cu``) at its tool's inputs
  (V=256, B=1024, the one-hot rows on a seeded random table), with the
  new body's time segments per voice, and K17's three layouts
  (``csrc/fractabl.cu``) at B=1024 and 4096 on the models' lanes and off
  them; each new output ``torch.equal`` to the old build's, y included,
  and the state planes (K17: every output) to the plain version; and
  (``probe_fract_layout``) K17 direct's body into the tool's ``[B, 3,
  V]`` and into K12's ``[3, B, V]``, beside K17 direct and K12.

Times are device µs per launch from CUDA events around 20 back-to-back
launches queued behind a ~2 ms sleep kernel (``tools.event_us``: the
host's enqueueing stays off the card's clock), the median over 5 windows,
beside each call's chain floor (``tools.chain_floor_us`` at the SM clock
``tools.sm_clock_mhz`` reads; K2's at its row's segment count).  On the
card only.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import statistics
from pathlib import Path

import numpy as np
import torch

from . import (adsr_regime, card, chain_floor_us, event_us, sass_counts,
               sm_clock_mhz)
from ..ops.cuda import adsr as kadsr
from ..ops.cuda import additive as add
from ..ops.cuda import build, iir
from ..ops.cuda import fm as kfm
from ..ops.cuda import fractabl as kfa
from ..ops.cuda import kabl as kab
from ..ops.cuda import phase as kphase

WINDOWS = 5
LAUNCHES = 20
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PHASE_PROBES = {0: "(a) as is", 1: "(b) dt from a register",
                2: "(c) the ring with floor"}
TPT_PROBES = {0: "as is", 1: "x from a register", 2: "unroll 16",
              3: "unroll 1"}
LP18_PROBES = {0: "(a) as is", 1: "(b) x from a register",
               2: "(c) tanh = identity", 3: "(d) division = product",
               4: "b+c+d, the bare chain", 5: "unroll 16",
               6: "c+d, loads only"}
LAT = ("FMUL+FADD", "DFMA", "F2F+DADD+F2F", "LDS", "DMUL", "FADD+div",
       "FADD+FRND.FLOOR+FADD", "FADD+FSETP+FSEL+FADD",
       "FADD+(FSETP,FADD)+FSEL", "FADD+FSET+FADD")
# K6's shapes: the poly synth's 256 voices, the 4x saturator's one lane
PHASE_SHAPES = ((256, 1024), (256, 4096), (1, 4096), (1, 16384))
# K1's, K3's and K4's: the piano's 256 voices (with the mix, and without
# at 1024)
ADD_SHAPES = ((1024, True), (4096, True), (1024, False))
# K3 / K4 with every voice's entry step off the cycle (no mix: a stuck
# voice's rows reach ~1e37 before they overflow, and a sum over 256 such
# voices may overflow in one order and not in another)
ODD_AB = (1024, 4096)
# K2's: the piano's 256 voices
PARITY_AB = (1024, 4096)
# K10's: the 4x IIR saturator's two lanes over 2B and B steps per block
ALLPASS_AB = ((2, 2048), (2, 1024), (2, 8192), (2, 4096))
# K11: the poly synth's 256 voices in the regimes its design treats apart
# (tools.ADSR_REGIMES): held from t = 0, a whole block in decay or in
# release, gate-on into sustain, a per-sample sus_param ramp, stages ending
# at chunk edges
ADSR_AB = tuple((r, B) for r in ("sustain", "decay", "release", "gate_on",
                                 "ramp", "edge") for B in (1024, 4096))
# the chain floor of a block in one stage (tools.CHAIN_OPS)
ADSR_FLOOR = {"decay": "adsr_scan", "release": "adsr_release"}
# K13 / K15: 256 voices, dt as rows or per sample (a note-on block)
CHAIN_SHAPES = tuple((B, ps) for B in (1024, 4096) for ps in (False, True))
# probe_chain's variants: (name, computes the kernel's numbers)
CHAIN_PROBES = {1: ("one warp, skewed by a sample, inputs from global",
                    True),
                2: ("one warp in tick order on the ring", True),
                6: ("one warp, skewed by a sample, on the ring", True),
                3: ("op3 alone, one warp on the ring", False),
                4: ("(6) with the sine unrounded", False),
                5: ("(6) without the phase wraps", False)}
# K9: the IIR lowpass's lane (one instance, per-sample planes) and 256
# lanes with planes and with rows; the ring probes take planes only
BIQUAD_PROBE_SHAPES = ((1, 1024, True), (256, 1024, True), (256, 1024, False))
BIQUAD_AB = tuple((V, B, ps) for V, ps in ((1, True), (256, False),
                                           (256, True))
                  for B in (1024, 4096))
# probe_biquad's variants: (name, computes the kernel's numbers, planes
# only)
BIQUAD_PROBES = {0: ("(a) old body as is", True, False),
                 1: ("(b) old, x and coefficients from registers", False,
                     False),
                 2: ("(c) old, no snaps", False, False),
                 3: ("(b+c) old, the bare chain", False, False),
                 4: ("ring, no snaps", False, True),
                 5: ("ring, y stored by the chain warp", True, True),
                 6: ("ring, y staged (the shipped body's copy)", True, True),
                 7: ("ring, the chain warp reads no shared memory", False,
                     True),
                 8: ("ring, y stored, the producer copies nothing", False,
                     True)}
# K14: the unfused fm voice's 256 voices
OPERATOR_SHAPES = (1024, 4096)
OPERATOR_PROBES = {0: ("(a) old body as is", True),
                   1: ("(b) old, the planes from registers", False),
                   2: ("(c) old, no * lvl", False),
                   3: ("(b+c) old", False),
                   4: ("ring, y stored by the chain warp", True),
                   5: ("ring, y staged (the shipped body's copy)", True),
                   6: ("ring, the chain warp reads no shared memory", False),
                   7: ("ring, y stored, the producer copies nothing", False)}


def _typed(fn, argtypes):
    fn.argtypes = argtypes
    fn.restype = I
    return fn


def _probe_lib():
    lib = build.load_library("scanprobe")
    _typed(lib.probe_phase, [I] + [P] * 4 + [I] * 2 + [P])
    _typed(lib.probe_tpt, [I] + [P] * 9 + [I] * 5 + [P])
    _typed(lib.probe_lp18, [I] + [P] * 6 + [I] * 4 + [P])
    _typed(lib.probe_lat, [P, P, I])
    _typed(lib.probe_chain, [I, I] + [P] * 11 + [I] * 3 + [P])
    _typed(lib.probe_biquad, [I] + [P] * 11 + [I] * 7 + [P])
    _typed(lib.probe_operator, [I] + [P] * 10 + [I] * 2 + [P])
    _typed(lib.probe_fract_direct, [I] + [P] * 4 + [I] * 2 + [P])
    return lib


def _entries(csrc: Path):
    """The C entry points of one tree's sources, typed: K7, K8, K6, K1-K4,
    K9, K10, K11, K12, K13, K14 and K15 by name."""
    lib = build.load_library("iir", csrc)
    fm = build.load_library("fm", csrc)
    return {
        "tpt_svf_scan": _typed(lib.oscen_tpt_svf_scan, [P] * 9 + [I] * 5 + [P]),
        "lp18_scan": _typed(lib.oscen_lp18_scan, [P] * 6 + [I] * 4 + [P]),
        "phase_scan": _typed(build.load_library("phase", csrc)
                             .oscen_phase_scan, [P] * 4 + [I] * 2 + [P]),
        **{f"additive_{v}": _typed(getattr(build.load_library(
            "additive", csrc), f"oscen_additive_{v}"), [P] * 17 + [I] * 5
            + [P]) for v in ("v4", "v3", "v2", "parity")},
        "fract_phase3": _typed(fm.oscen_fract_phase3, [P] * 4 + [I] * 2
                               + [F, P]),
        "allpass_cascade_scan": _typed(lib.oscen_allpass_cascade_scan,
                                       [P] * 7 + [I] * 3 + [P]),
        "fm_chain3_scan": _typed(fm.oscen_fm_chain3_scan,
                                 [P] * 11 + [I] * 3 + [F, P]),
        "pivot_chain3_scan": _typed(fm.oscen_pivot_chain3_scan,
                                    [P] * 11 + [I] * 3 + [F, P]),
        "biquad_scan": _typed(lib.oscen_biquad_scan, [P] * 11 + [I] * 7
                              + [P]),
        "fm_operator_scan": _typed(fm.oscen_fm_operator_scan,
                                   [P] * 10 + [I] * 2 + [P]),
        "adsr_scan": _typed(build.load_library("adsr", csrc).oscen_adsr_scan,
                            [P] * 9 + [I] * 2 + [P]),
    }


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed ({rc})")


def _cases(dev, rng):
    """(kernel, label, B, operands, strides) of K7 and K8 at the main
    paths' shapes."""
    def T(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    out = []
    for V, B, ps in ((256, 1024, False), (256, 4096, False),
                     (256, 1024, True), (256, 4096, True),
                     (1, 1024, False), (1, 4096, False)):
        cs = (B, V) if ps else (V,)
        ops = (T(rng.standard_normal((B, V))), T(rng.uniform(0.3, 0.9, cs)),
               T(rng.uniform(0.05, 0.5, cs)), T(rng.uniform(1, 2, cs)),
               T(rng.uniform(-1, 1, V)), T(rng.uniform(-1, 1, V)))
        out.append(("tpt_svf_scan", f"V={V} B={B} "
                    f"{'per-sample' if ps else 'rows'}", B, ops,
                    [V if ps else 0] * 3))
    for V, B, ps in ((2, 1024, False), (2, 4096, False), (1, 1024, False),
                     (1, 4096, False), (2, 1024, True), (2, 4096, True)):
        cs = (B, V) if ps else (V,)
        ops = (T(0.3 * rng.standard_normal((B, V))),
               T(np.tan(np.pi * rng.uniform(0.01, 0.05, cs))),
               T(rng.uniform(1.0, 1.6, cs)), T(rng.uniform(-0.1, 0.1, (3, V))))
        out.append(("lp18_scan", f"V={V} B={B} {'sweep' if ps else 'rows'}",
                    B, ops, [V if ps else 0] * 2))
    return out


def _launcher(fn, kernel, ops, strides):
    x = ops[0]
    B, V = x.shape
    if kernel == "tpt_svf_scan":
        outs = (torch.empty_like(x), torch.empty_like(ops[4]),
                torch.empty_like(ops[5]))
    else:
        outs = (torch.empty_like(x), torch.empty_like(ops[3]))

    def run():
        _check(fn(*[t.data_ptr() for t in ops], *[t.data_ptr() for t in outs],
                  V, B, *strides, torch.cuda.current_stream().cuda_stream),
               kernel)
        return outs
    return run


def _phase_inputs(dev, V, B, seed):
    """The poly synth's and saturator's dt: in (0, 0.5), a phase in [0, 1)."""
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.uniform(0, 1, V).astype(np.float32),
                            device=dev),
            torch.as_tensor(rng.uniform(0.001, 0.5, (B, V)).astype(
                np.float32), device=dev))


def _phase_launcher(fn, p0, dt, extra=(), tail=()):
    """fn(phase0, dt, before, carry, *extra, V, B, *tail, stream) on
    preallocated outputs."""
    B, V = dt.shape
    before, carry = torch.empty_like(dt), torch.empty_like(p0)

    def run():
        _check(fn(p0.data_ptr(), dt.data_ptr(), before.data_ptr(),
                  carry.data_ptr(), *extra, V, B, *tail,
                  torch.cuda.current_stream().cuda_stream), "phase_scan")
        return before, carry
    return run


def _additive_inputs(dev, V=256, seed=0, steps="cycle"):
    """The piano's shapes: seeded planes, steps 0..64 with the edges
    (``cycle``), or every voice off the cycle: ``stuck`` at -2^25, or
    ``half`` in -2.5 .. 63.5."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 0.2, (32, V))
    step = rng.integers(0, 65, (V,)).astype(np.float32)
    step[:3] = (0.0, 64.0, 33.0)
    if steps == "stuck":
        step[:] = -2.0 ** 25
    elif steps == "half":
        step = rng.integers(-3, 64, (V,)).astype(np.float32) + 0.5
    planes = [rng.normal(size=(32, V)), rng.normal(size=(32, V)),
              np.cos(th), np.sin(th), rng.uniform(0, 1, (32, V)),
              rng.uniform(0, 1, (32, V)), rng.uniform(0.9, 1.0, (32, V))]
    return ([torch.as_tensor(np.asarray(p, np.float32), device=dev)
             for p in planes], torch.as_tensor(step, device=dev))


def _additive_launcher(fn, planes, step, B, with_mix, tail=(),
                       version="v4"):
    """One launch of ``fn`` (a C entry of ``csrc/additive.cu`` for
    ``version``, with its arguments) on preallocated outputs; ``tail`` goes
    before the stream (the segment entry's version and count)."""
    V = planes[0].shape[1]
    dev = planes[0].device
    sub = add.subgroup_len(B, version)
    n_blk = -(-V // add.WARPS_PER_BLOCK)
    n_grp = -(-n_blk // add.MIX_GROUP)
    part = cnt = None
    if with_mix:
        part = torch.empty((n_blk + n_grp + 1, B), device=dev)
        cnt = torch.zeros((1 + n_grp,), dtype=torch.int32, device=dev)
        y = torch.empty((B,), device=dev)
    else:
        y = torch.empty((B, V), device=dev)
    outs = [torch.empty_like(planes[0]) for _ in range(4)]
    step_o = torch.empty_like(step)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def run():
        _check(fn(*[t.data_ptr() for t in planes], step.data_ptr(),
                  y.data_ptr(), ptr(part), ptr(cnt), None,
                  *[t.data_ptr() for t in outs], step_o.data_ptr(), V, B,
                  sub, int(with_mix), add.WARPS_PER_BLOCK, *tail,
                  torch.cuda.current_stream().cuda_stream),
               f"additive {version}")
        return (y, *outs, step_o)
    return run


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _same_nan(a, b):
    """``_same`` with NaN equal to NaN."""
    def eq(x, y):
        nx, ny = torch.isnan(x), torch.isnan(y)
        return torch.equal(nx, ny) and torch.equal(x[~nx], y[~ny])
    return all(eq(x, y) for x, y in zip(a, b))


def _additive_ok(got, planes, step, B, with_mix, version="v4", ref=None):
    """An additive kernel's bounds against its plain version (``ref``,
    computed if not given): state planes torch.equal, y within 5e-5 (x
    sqrt(V) with the mix)."""
    if ref is None:
        ref = add.plain_block(*planes, step, B, with_mix, version)
    tol = 5e-5 * (math.sqrt(planes[0].shape[1]) if with_mix else 1.0)
    return (float((got[0] - ref[0]).abs().max()) <= tol
            and _same(got[1:], ref[1:]))


def _additive_stuck_ok(got, planes, step, B, version, ref=None,
                       with_mix=False):
    """A stuck voice's p (parity: cur) overflows after ~7 ticks: the state
    planes equal the plain version's (``ref``, computed if not given)
    with NaN equal to NaN, and without the mix y is NaN where its y is
    (with it, a sum of overflowing voices may overflow in one order and
    not in another: the mix is held to the old body's alone)."""
    if ref is None:
        ref = add.plain_block(*planes, step, B, False, version)
    return (_same_nan(got[1:], ref[1:])
            and (with_mix or torch.equal(torch.isnan(got[0]),
                                         torch.isnan(ref[0]))))


def _fract_launcher(fn, p0, dt, B):
    """fn(phases, dt, out, carry, V, B, stream) (K12) on preallocated
    outputs; returns (ph3, ph2, ph1, carry)."""
    V = p0.shape[1]
    out = torch.empty((3, B, V), device=p0.device)
    carry = torch.empty_like(p0)

    def run():
        _check(fn(p0.data_ptr(), dt.data_ptr(), out.data_ptr(),
                  carry.data_ptr(), V, B, 1.0,
                  torch.cuda.current_stream().cuda_stream), "fract_phase3")
        return out[0], out[1], out[2], carry
    return run


def _fract_inputs(dev, lanes, B, seed):
    """K12's phases and dt [3, 256]: the models' (``on``: p0 in [0, 1), dt
    in (0, 0.5), the short wrap), every lane off it (``off``: p0 in (-1,
    0]), or even lanes on and odd lanes off (``mixed``: every warp runs
    both loops)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, (3, 256))
    if lanes == "off":
        p = -p
    elif lanes == "mixed":
        p[:, 1::2] *= -1
    return [torch.as_tensor(np.asarray(a, np.float32), device=dev)
            for a in (p, rng.uniform(0.001, 0.5, (3, 256)))]


def _bits_equal(a, b):
    """Every output equal on its int32 bit patterns."""
    return all(torch.equal(x.contiguous().view(torch.int32),
                           y.contiguous().view(torch.int32))
               for x, y in zip(a, b))


def _ptxas_regs(log: str, pattern: str):
    """The ``Used N registers`` and spill lines ptxas -v gave the entry
    function matching ``pattern``, from a build log."""
    fn, out = None, []
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", ln)
        if m:
            fn = m.group(1)
        elif fn and re.search(pattern, fn) and (
                "registers" in ln or "spill" in ln):
            out.append(ln.split(":", 1)[-1].strip())
    return "; ".join(dict.fromkeys(out)) or "not in this process's builds"


def _allpass_inputs(dev, V, B, seed):
    """The IIR saturator's operands: both halfband branches' betas as
    lanes (S = 2), noise in, histories in [-1, 1)."""
    from ..ops.resample import BRANCH_A_BETAS, BRANCH_B_BETAS
    rng = np.random.default_rng(seed)
    betas = np.array([BRANCH_A_BETAS, BRANCH_B_BETAS], np.float32).T
    return [torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
            for a in (rng.standard_normal((B, V)), np.tile(betas, (1, V))[:, :V],
                      rng.uniform(-1, 1, (2, V)), rng.uniform(-1, 1, (2, V)))]


def _allpass_launcher(fn, ops):
    """fn(x, a, xp, yp, y, xp', yp', V, B, S, stream) on preallocated
    outputs."""
    x, a = ops[0], ops[1]
    B, V = x.shape
    outs = (torch.empty_like(x), torch.empty_like(ops[2]),
            torch.empty_like(ops[3]))

    def run():
        _check(fn(*[t.data_ptr() for t in ops],
                  *[t.data_ptr() for t in outs], V, B, a.shape[0],
                  torch.cuda.current_stream().cuda_stream),
               "allpass_cascade_scan")
        return outs
    return run


def _chain_inputs(dev, V, B, per_sample, seed):
    """The chains' operands after the carries (phases, prevs): dt per
    sample (the pitch steps a third of the way in) or as rows, feedback on
    every operator, level-folded envelopes; and lvl (ones) for the plain
    versions."""
    rng = np.random.default_rng(seed)
    freq = np.broadcast_to(rng.uniform(100, 1000, V), (B, V)).copy()
    if per_sample:
        freq[B // 3:, ::2] *= 1.5
    dt = np.stack([freq * r / 48000.0 for r in (3.0, 2.0, 1.0)])
    if not per_sample:
        dt = dt[:, :1]
    ops = [torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
           for a in (rng.uniform(0, 1, (3, V)), rng.normal(size=(3, V)), dt,
                     rng.uniform(0.2, 0.6, (3, V)), rng.uniform(0, 1, V),
                     *[rng.uniform(0.1, 1.0, (B, V)) for _ in range(3)])]
    return ops, torch.ones(3, V, device=dev)


def _chain_launcher(fn, ops, head=(), tail=(1.0,)):
    """fn(*head, phases, prevs, dt, fb, mix, e3, e2, e1, y, phases',
    prevs', V, B, dt_stride, *tail, stream) on preallocated outputs (a
    shipped chain's tail is its inv, 1: each phase steps by p + dt; a
    probe's is empty)."""
    B, V = ops[5].shape
    outs = (torch.empty_like(ops[5]), torch.empty_like(ops[0]),
            torch.empty_like(ops[1]))
    stride = V if ops[2].shape[1] == B and B > 1 else 0

    def run():
        _check(fn(*head, *[t.data_ptr() for t in ops],
                  *[t.data_ptr() for t in outs], V, B, stride, *tail,
                  torch.cuda.current_stream().cuda_stream), "chain3")
        return outs
    return run


def _chain_plain(kernel, ops, lvl):
    """The plain version of ``kernel`` on ``_chain_inputs``' operands."""
    plain = getattr(kfm, f"plain_{kernel}")
    phases, prevs, dt, fb, mix, *env = ops
    return plain(phases, prevs, dt, lvl, fb, mix, *env)


def _biquad_inputs(dev, V, B, planes, seed):
    """The IIR lowpass's operands: noise in, JUCE lowpass coefficients
    (iir_lowpass/mod.rs:84-100) for cutoffs in [1500, 8000] Hz at q =
    1/sqrt(2), as per-sample planes or rows, states in [-1, 1)."""
    rng = np.random.default_rng(seed)
    cut = rng.uniform(1500.0, 8000.0, (B, V) if planes else (V,))
    n = 1.0 / np.tan(np.pi * cut / 48000.0)
    r2 = math.sqrt(2.0)
    c1 = 1.0 / (1.0 + r2 * n + n * n)
    return [torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in (
        0.5 * rng.standard_normal((B, V)), c1, 2 * c1, c1,
        2 * c1 * (1 - n * n), c1 * (1 - r2 * n + n * n),
        rng.uniform(-1, 1, V), rng.uniform(-1, 1, V))]


def _biquad_launcher(fn, ops, head=()):
    """fn(*head, x, b0, b1, b2, a1, a2, v1, v2, y, v1', v2', V, B, five
    time strides, stream) on preallocated outputs."""
    x = ops[0]
    B, V = x.shape
    outs = (torch.empty_like(x), torch.empty_like(ops[6]),
            torch.empty_like(ops[7]))
    strides = [V if c.dim() == 2 else 0 for c in ops[1:6]]

    def run():
        _check(fn(*head, *[t.data_ptr() for t in ops],
                  *[t.data_ptr() for t in outs], V, B, *strides,
                  torch.cuda.current_stream().cuda_stream), "biquad_scan")
        return outs
    return run


def _operator_inputs(dev, V, B, seed):
    """The FmOperator's operands: phase and carry, then dt, pm, fb, env and
    lvl planes over the ranges of chip_smoke.py's K14 check."""
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in (
        rng.uniform(0, 1, V), rng.uniform(-1, 1, V),
        *[rng.uniform(lo, hi, (B, V)) for lo, hi in (
            (0.002, 0.03), (-0.2, 0.2), (0.0, 0.6), (0.1, 1.0),
            (0.3, 1.0))])]


def _operator_launcher(fn, ops, head=()):
    """fn(*head, phase0, prev0, dt, pm, fb, env, lvl, y, phase', prev', V,
    B, stream) on preallocated outputs."""
    B, V = ops[2].shape
    outs = (torch.empty_like(ops[2]), torch.empty_like(ops[0]),
            torch.empty_like(ops[1]))

    def run():
        _check(fn(*head, *[t.data_ptr() for t in ops],
                  *[t.data_ptr() for t in outs], V, B,
                  torch.cuda.current_stream().cuda_stream),
               "fm_operator_scan")
        return outs
    return run


def _adsr_launcher(fn, st, rows, sus):
    """fn(state7, a_n, d_n, r_n, a_c, d_c, sus_param, levels, state7', V,
    B, stream) on preallocated outputs."""
    B, V = sus.shape
    y, st_o = torch.empty_like(sus), torch.empty_like(st)

    def run():
        _check(fn(st.data_ptr(), *[r.data_ptr() for r in rows],
                  sus.data_ptr(), y.data_ptr(), st_o.data_ptr(), V, B,
                  torch.cuda.current_stream().cuda_stream), "adsr_scan")
        return y, st_o
    return run


def _dt_label(per_sample):
    return "dt per sample" if per_sample else "dt rows"


def registers(names):
    """ptxas's register count of every kernel whose name contains one of
    ``names``, from the builds of this process (``build.build_info``)."""
    import re
    out = {}
    for lib, (_, log) in build.build_info.items():
        fn = None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", ln)
            if m and fn and any(n in fn for n in names):
                out[f"{lib}:{fn}"] = int(m.group(1))
    return out


def local_memory():
    """LDL / STL in every shipped chain3_kernel, allpass_kernel,
    biquad_kernel and fm_operator_kernel instance (their libraries' SASS),
    and the registers ptxas gave them; K9's and K14's instances one by one.
    Local memory in a K9 or K14 instance fails the run."""
    for fn, n in registers(("chain3_kernel", "allpass_kernel",
                            "chain_ring", "biquad_kernel", "biquad_ring",
                            "fm_operator_kernel", "operator_ring")).items():
        print(f"[probe] registers {fn}: {n}", flush=True)
    for name, kern in (("fm", "chain3_kernel"), ("iir", "allpass_kernel"),
                       ("iir", "biquad_kernel"),
                       ("fm", "fm_operator_kernel")):
        lib = build.BUILD_DIR / f"lib{name}-{build.source_digest(name)}.so"
        counts = sass_counts(lib, ("LDL", "STL"))
        rows = {f: c for f, c in counts.items() if kern in f}
        if not rows:
            raise SystemExit(f"no {kern} in {lib.name}'s SASS")
        local = sum(c["LDL"] + c["STL"] for c in rows.values())
        print(f"[probe] {name}.cu {kern}: {len(rows)} instances, LDL "
              f"{sum(c['LDL'] for c in rows.values())}, STL "
              f"{sum(c['STL'] for c in rows.values())}; instructions "
              + ", ".join(str(c["instr"]) for c in rows.values()),
              flush=True)
        if kern in ("biquad_kernel", "fm_operator_kernel"):
            for f, c in rows.items():
                print(f"[probe]   {f}: LDL {c['LDL']}, STL {c['STL']}, "
                      f"{c['instr']} instructions", flush=True)
            if local:
                raise SystemExit(f"{kern}: {local} local-memory "
                                 f"instructions")


def latency(dev):
    lib = _probe_lib()
    out = torch.zeros(4, device=dev)
    cyc = torch.zeros(16, dtype=torch.int64, device=dev)
    n = 4096
    _check(lib.probe_lat(out.data_ptr(), cyc.data_ptr(), n), "lat_kernel")
    c = (cyc.cpu().numpy()[:len(LAT)] / n).tolist()
    print("[latency] cycles per dependent step: " + ", ".join(
        f"{k} {v:.1f}" for k, v in zip(LAT, c)), flush=True)


def _print_rows(rows, mhz, tag="probe"):
    res = {i: [] for i in range(len(rows))}
    for _ in range(WINDOWS):
        for i, row in enumerate(rows):
            res[i].append(event_us(row[-1], LAUNCHES))
    for i, (kernel, label, B, name, _) in enumerate(rows):
        us = statistics.median(res[i])
        print(f"[{tag}] {kernel} {label} {name}: {us:.2f} us, "
              f"{us * mhz / B:.1f} cycles per step at {mhz:.0f} MHz",
              flush=True)


def probe(dev, mhz):
    lib = _probe_lib()
    shipped_k6 = _entries(build.CSRC_DIR)["phase_scan"]
    rng = np.random.default_rng(0)
    rows = []
    for V, B in PHASE_SHAPES[:3]:
        p0, dt = _phase_inputs(dev, V, B, V + B)
        ref = kphase.plain_phase_scan(p0, dt)
        bodies = [(name, _phase_launcher(
            lambda *a, v=var: lib.probe_phase(v, *a), p0, dt))
            for var, name in PHASE_PROBES.items()]
        bodies.append(("shipped", _phase_launcher(shipped_k6, p0, dt)))
        kphase.take_reruns(dev)
        for name, run in bodies:
            if name != "(b) dt from a register":   # (b) computes another sum
                got = run()
                torch.cuda.synchronize()
                if not _same(got, ref):
                    raise SystemExit(f"K6 {name} differs from the plain "
                                     f"version")
            rows.append(("phase_scan", f"V={V} B={B}", B, name, run))
        if kphase.take_reruns(dev):
            raise SystemExit("K6 re-ran a chunk of in-range dt")
    for kernel, label, B, ops, strides in _cases(dev, rng):
        if "rows" not in label:
            continue
        table = TPT_PROBES if kernel == "tpt_svf_scan" else LP18_PROBES
        entry = lib.probe_tpt if kernel == "tpt_svf_scan" else lib.probe_lp18
        for var, name in table.items():
            run = _launcher(lambda *a, e=entry, var=var: e(var, *a), kernel,
                            ops, strides)
            rows.append((kernel, label, B, name, run))
    seg = _typed(build.load_library("additive").oscen_additive_closed_segs,
                 [P] * 17 + [I] * 7 + [P])
    shipped = _typed(build.load_library("additive").oscen_additive_v4,
                     [P] * 17 + [I] * 5 + [P])
    planes, step = _additive_inputs(dev)
    for B in (1024, 4096):
        ref = [t.clone() for t in
               _additive_launcher(shipped, planes, step, B, True)()]
        for S in (1, 2, 4):
            run = _additive_launcher(seg, planes, step, B, True, (4, S))
            got = run()
            torch.cuda.synchronize()
            if not _same(got, ref):
                raise SystemExit(f"K1 with {S} segments differs from the "
                                 f"shipped body")
            rows.append(("additive_v4", f"V=256 B={B} with_mix", B,
                         f"S={S}", run))
    shipped = _entries(build.CSRC_DIR)
    for kernel in ("pivot_chain3_scan", "fm_chain3_scan"):
        for B, ps in CHAIN_SHAPES:
            ops, lvl = _chain_inputs(dev, 256, B, ps, B + ps)
            ref = _chain_plain(kernel, ops, lvl)
            # the probes keep the unfused bodies: exact for the fm chain only
            bodies = [(name, exact and kernel == "fm_chain3_scan",
                       _chain_launcher(lib.probe_chain, ops,
                                       (var, int(kernel.startswith("pivot"))),
                                       ()))
                      for var, (name, exact) in CHAIN_PROBES.items()]
            bodies.append(("shipped: a warp per operator, on the ring",
                           True, _chain_launcher(shipped[kernel], ops)))
            for name, exact, run in bodies:
                got = run()
                torch.cuda.synchronize()
                if exact and not _same(got, ref):
                    raise SystemExit(f"{kernel} {name} differs from the "
                                     f"plain version")
                rows.append((kernel, f"V=256 B={B} {_dt_label(ps)}", B,
                             name, run))
    for V, B, ps in BIQUAD_PROBE_SHAPES:
        ops = _biquad_inputs(dev, V, B, ps, 11 * V + B)
        ref = iir.plain_biquad_scan(*ops)
        bodies = [(name, exact, _biquad_launcher(lib.probe_biquad, ops,
                                                 (var,)))
                  for var, (name, exact, planes_only) in BIQUAD_PROBES.items()
                  if ps or not planes_only]
        bodies.append(("shipped", True, _biquad_launcher(
            shipped["biquad_scan"], ops)))
        label = f"V={V} B={B} {'planes' if ps else 'rows'}"
        for name, exact, run in bodies:
            got = run()
            torch.cuda.synchronize()
            if exact and not _same(got, ref):
                raise SystemExit(f"biquad_scan {label} {name} differs from "
                                 f"the plain version")
            rows.append(("biquad_scan", label, B, name, run))
    for B in OPERATOR_SHAPES:
        ops = _operator_inputs(dev, 256, B, 13 * B)
        ref = kfm.plain_fm_operator_scan(*ops)
        bodies = [(name, exact, _operator_launcher(lib.probe_operator, ops,
                                                   (var,)))
                  for var, (name, exact) in OPERATOR_PROBES.items()]
        bodies.append(("shipped", True, _operator_launcher(
            shipped["fm_operator_scan"], ops)))
        for name, exact, run in bodies:
            got = run()
            torch.cuda.synchronize()
            if exact and not _same(got, ref):
                raise SystemExit(f"fm_operator_scan B={B} {name} differs "
                                 f"from the plain version")
            rows.append(("fm_operator_scan", f"V=256 B={B}", B, name, run))
    _print_rows(rows, mhz)
    local_memory()


# K11's probes: adsr.cu with text edits (each line must be in the source),
# built beside the shipped one: the ring of scan_stage.cuh's depth (3
# chunks, each chunk's copies awaited before the next is issued), and, for
# timing only (their outputs differ), the level's chain cut (each step from
# its input alone), the release's quotient check left out, and the ring
# alone: a decaying chunk's body emptied, then also without the producer's
# copies, then also without its write-backs and waits (the barriers alone)
_ADSR_EMPTY = ("      l.fast<kChunk, true, false>(x, ys);",
               "      ys[0] = x[0] + x[31];")
_ADSR_NO_COPY = ("        cp_async_if<16>(dst + r * kLanes + col,",
                 "        if (false) cp_async_if<16>(dst + r * kLanes + col,")
ADSR_PROBES = {
    "shipped": (),
    "ring of 3, 1 chunk of copies in flight": (
        ("constexpr int kRing = 5;", "constexpr int kRing = 3;"),
        ("constexpr int kAhead = 3;", "constexpr int kAhead = 1;")),
    "no level chain (timing only)": (
        ("const float e = clip01(level + ((isA ? 1.0f : s) - level) * c);",
         "const float e = clip01(s + ((isA ? 1.0f : s) - s) * c);"),),
    "release quotient unchecked (timing only)": (
        ("const bool ok = !kR || !isR || worst < 0.0f;",
         "const bool ok = true;"),),
    "ring alone, decay's body empty (timing only)": (_ADSR_EMPTY,),
    "ring alone, no copies (timing only)": (_ADSR_EMPTY, _ADSR_NO_COPY),
    "barriers alone (timing only)": (
        _ADSR_EMPTY, _ADSR_NO_COPY,
        ("      wait_groups<kAhead>();\n", ""),
        ("      io.write_back(k - kRing);", "")),
}
ADSR_PROBE_REGIMES = ("decay", "release", "gate_on", "sustain")


def probe_adsr(dev, mhz):
    """K11 (adsr_scan) at V=256, B=1024 in its regimes, the shipped body
    beside ``ADSR_PROBES``' edits of it; each first checked against the
    plain version (the timing-only edits print False)."""
    import shutil
    src = (build.CSRC_DIR / "adsr.cu").read_text()
    fns = {}
    for name, edits in ADSR_PROBES.items():
        text = src
        for a, b in edits:
            if a not in text:
                raise SystemExit(f"adsr probe {name!r}: {a!r} is not in "
                                 f"adsr.cu")
            text = text.replace(a, b)
        d = build.BUILD_DIR / "adsr_probe" / re.sub(r"\W+", "_", name)
        d.mkdir(parents=True, exist_ok=True)
        (d / "adsr.cu").write_text(text)
        shutil.copy(build.CSRC_DIR / "scan_stage.cuh", d)
        fns[name] = _typed(build.load_library("adsr", d).oscen_adsr_scan,
                           [P] * 9 + [I] * 2 + [P])
    for regime in ADSR_PROBE_REGIMES:
        st, rows, sus = adsr_regime(regime, 256, 1024, seed=1, device=dev)
        ref = kadsr.plain_adsr_scan(st, *rows, sus)
        runs = {n: _adsr_launcher(fn, st, rows, sus) for n, fn in fns.items()}
        same = {}
        for n, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            same[n] = _same(got, ref)
        if not same["shipped"]:
            raise SystemExit(f"adsr_scan {regime}: the shipped body is not "
                             f"equal to the plain version")
        t = {n: [] for n in runs}
        for _ in range(WINDOWS):
            for n, run in runs.items():
                t[n].append(event_us(run, LAUNCHES))
        for n in runs:
            us = statistics.median(t[n])
            print(f"[probe] adsr_scan V=256 B=1024 {regime} {n}: {us:.2f} "
                  f"us, {us * mhz / 1024:.1f} cycles per step at {mhz:.0f} "
                  f"MHz, equal to the plain version {same[n]}", flush=True)


def ab(dev, old: Path, mhz):
    """Old and new bodies in turns (old, new, new, old) per window."""
    old_csrc = old / "oscen_tpu_torch" / "csrc"
    old_fns, new_fns = _entries(old_csrc), _entries(build.CSRC_DIR)
    for tree, csrc in (("old", old_csrc), ("new", build.CSRC_DIR)):
        lib = build.BUILD_DIR / (f"libadditive-"
                                 f"{build.source_digest('additive', csrc)}.so")
        counts = sass_counts(lib, ("LDL", "STL"))
        # the parent's template has no epilogue switch
        k = next((f for f in counts if "additive_closed_kernelILi64ELi4E"
                  in f and "Lb1E" not in f), None)
        print(f"[ab] {tree} additive.cu additive_closed_kernel<64, 4> SASS: "
              + (f"LDL {counts[k]['LDL']}, STL {counts[k]['STL']}, "
                 f"{counts[k]['instr']} instructions" if k else "not found"),
              flush=True)
        # K3 and K4: every SUB's instance
        log = build.build_info.get("additive" if tree == "new" else
                                   f"additive@{csrc}", (0.0, ""))[1]
        for ver in (3, 2):
            inst = {f: c for f, c in counts.items()
                    if re.search(rf"additive_closed_kernelILi\d+ELi{ver}E",
                                 f)}
            local = sum(c["LDL"] + c["STL"] for c in inst.values())
            print(f"[ab] {tree} additive.cu additive_closed_kernel<SUB, "
                  f"{ver}> SASS: {len(inst)} instances, LDL + STL {local}, "
                  f"{sorted(c['instr'] for c in inst.values())} "
                  f"instructions; <64, {ver}> ptxas: "
                  f"{_ptxas_regs(log, rf'ILi64ELi{ver}E')}", flush=True)
            if tree == "new" and (local or not inst):
                raise SystemExit(f"additive_closed_kernel<SUB, {ver}>: "
                                 f"{local} local-memory instructions in "
                                 f"{len(inst)} instances")
        # K2: every N's instance, its local memory and FFMA (none with
        # --fmad=false; an IEEE division would bring its own)
        par = sass_counts(lib, ("LDL", "STL", "FFMA"))
        inst = {f: c for f, c in par.items()
                if "additive_parity_kernel" in f}
        print(f"[ab] {tree} additive.cu additive_parity_kernel<N> SASS: "
              + "; ".join(f"{f}: LDL {c['LDL']}, STL {c['STL']}, FFMA "
                          f"{c['FFMA']}, {c['instr']} instructions"
                          for f, c in inst.items())
              + f"; ptxas: {_ptxas_regs(log, 'additive_parity_kernel')}",
              flush=True)
        local = sum(c["LDL"] + c["STL"] + c["FFMA"] for c in inst.values())
        if tree == "new" and (local or not inst):
            raise SystemExit(f"additive_parity_kernel: {local} local-memory "
                             f"or FFMA instructions in {len(inst)} instances")
        # K12
        fm_lib = build.BUILD_DIR / (f"libfm-"
                                    f"{build.source_digest('fm', csrc)}.so")
        fm_log = build.build_info.get("fm" if tree == "new" else
                                      f"fm@{csrc}", (0.0, ""))[1]
        inst = {f: c for f, c in sass_counts(
            fm_lib, ("LDL", "STL", "FRND", "FSET")).items()
            if "fract_phase3_kernel" in f}
        print(f"[ab] {tree} fm.cu fract_phase3_kernel SASS: "
              + "; ".join(f"LDL {c['LDL']}, STL {c['STL']}, FRND "
                          f"{c['FRND']}, FSET {c['FSET']}, {c['instr']} "
                          f"instructions" for c in inst.values())
              + f"; ptxas: {_ptxas_regs(fm_log, 'fract_phase3_kernel')}",
              flush=True)
        if tree == "new" and (not inst or any(
                c["LDL"] + c["STL"] for c in inst.values())):
            raise SystemExit("fract_phase3_kernel: local memory")
        # K11
        lib = build.BUILD_DIR / (f"libadsr-"
                                 f"{build.source_digest('adsr', csrc)}.so")
        log = build.build_info.get("adsr" if tree == "new" else
                                   f"adsr@{csrc}", (0.0, ""))[1]
        inst = {f: c for f, c in sass_counts(
            lib, ("LDL", "STL", "MUFU", "FSEL", "FMNMX")).items()
            if "adsr_kernel" in f}
        print(f"[ab] {tree} adsr.cu adsr_kernel SASS: "
              + "; ".join(f"LDL {c['LDL']}, STL {c['STL']}, MUFU "
                          f"{c['MUFU']}, FSEL {c['FSEL']}, FMNMX "
                          f"{c['FMNMX']}, {c['instr']} instructions"
                          for c in inst.values())
              + f"; ptxas: {_ptxas_regs(log, 'adsr_kernel')}", flush=True)
        if tree == "new" and (not inst or any(
                c["LDL"] + c["STL"] for c in inst.values())):
            raise SystemExit("adsr_kernel: local memory")
    rng = np.random.default_rng(1)
    plain = {"tpt_svf_scan": iir.plain_tpt_svf_scan,
             "lp18_scan": iir.plain_lp18_scan}
    rows = []
    for kernel, label, B, ops, strides in _cases(dev, rng):
        runs = {w: _launcher(fns[kernel], kernel, ops, strides)
                for w, fns in (("old", old_fns), ("new", new_fns))}
        ref = plain[kernel](*ops)
        rows.append((kernel, label, B, runs, lambda got, ref=ref:
                     _same(got, ref)))
    for V, B in PHASE_SHAPES:
        p0, dt = _phase_inputs(dev, V, B, 7 * V + B)
        runs = {w: _phase_launcher(fns["phase_scan"], p0, dt)
                for w, fns in (("old", old_fns), ("new", new_fns))}
        ref = kphase.plain_phase_scan(p0, dt)
        rows.append(("phase_scan", f"V={V} B={B}", B, runs,
                     lambda got, ref=ref: _same(got, ref)))
    planes, step = _additive_inputs(dev)
    for version in ("v4", "v3", "v2"):
        for B, with_mix in ADD_SHAPES:
            runs = {w: _additive_launcher(fns[f"additive_{version}"], planes,
                                          step, B, with_mix)
                    for w, fns in (("old", old_fns), ("new", new_fns))}
            rows.append((f"additive_{version}", f"V=256 B={B}"
                         + (" with_mix" if with_mix else ""), B, runs,
                         lambda got, B=B, m=with_mix, v=version:
                         _additive_ok(got, planes, step, B, m, v)))
    for steps in ("stuck", "half"):
        pl, st = _additive_inputs(dev, steps=steps)
        for version in ("v3", "v2"):
            for B in ODD_AB:
                runs = {w: _additive_launcher(fns[f"additive_{version}"], pl,
                                              st, B, False)
                        for w, fns in (("old", old_fns), ("new", new_fns))}
                ok = (lambda got, B=B, v=version, pl=pl, st=st:
                      _additive_stuck_ok(got, pl, st, B, v)) \
                    if steps == "stuck" else \
                    (lambda got, B=B, v=version, pl=pl, st=st:
                     _additive_ok(got, pl, st, B, False, v))
                rows.append((f"additive_{version}", f"V=256 B={B} every "
                             f"voice off the cycle ({steps})", B, runs, ok))
    # K2 against the parent's one warp per voice: every voice on the
    # step's cycle, or stuck (-2^25), at 1, 2 and 4 segments
    par_segs = _typed(build.load_library("additive")
                      .oscen_additive_closed_segs, [P] * 17 + [I] * 7 + [P])
    for steps in ("cycle", "stuck"):
        pl, st = _additive_inputs(dev, steps=steps)
        for B in PARITY_AB:
            ref = add.plain_block(*pl, st, B, False, "parity")
            for with_mix in (False, True):
                if steps == "cycle":
                    mref = add.plain_block(*pl, st, B, True, "parity") \
                        if with_mix else ref
                    ok = (lambda got, B=B, m=with_mix, pl=pl, st=st,
                          r=mref: _additive_ok(got, pl, st, B, m, "parity",
                                               r))
                else:
                    ok = (lambda got, B=B, m=with_mix, pl=pl, st=st, r=ref:
                          _additive_stuck_ok(got, pl, st, B, "parity", r, m))
                for S in (1, 2, 4):
                    runs = {"old": _additive_launcher(
                        old_fns["additive_parity"], pl, st, B, with_mix,
                        version="parity"),
                        "new": _additive_launcher(
                            par_segs, pl, st, B, with_mix, (0, S),
                            version="parity")}
                    rows.append(("additive_parity", f"V=256 B={B}"
                                 + (" with_mix" if with_mix else "")
                                 + f" {steps} S={S}", B, runs, ok, S))
    # K12 on the models' lanes, lanes off the short wrap, and both
    for lanes in ("on", "off", "mixed"):
        for B in (1024, 4096):
            p0, dt = _fract_inputs(dev, lanes, B, 23 * B)
            runs = {w: _fract_launcher(fns["fract_phase3"], p0, dt, B)
                    for w, fns in (("old", old_fns), ("new", new_fns))}
            ref = kfm.plain_fract_phase3(p0, dt, B)
            rows.append(("fract_phase3", f"V=256 B={B} {lanes} lanes", B,
                         runs, lambda got, ref=ref: _bits_equal(got, ref)))
    for V, B in ALLPASS_AB:
        ops = _allpass_inputs(dev, V, B, 3 * V + B)
        runs = {w: _allpass_launcher(fns["allpass_cascade_scan"], ops)
                for w, fns in (("old", old_fns), ("new", new_fns))}
        ref = iir.plain_allpass_cascade_scan(*ops)
        rows.append(("allpass_cascade_scan", f"V={V} B={B}", B, runs,
                     lambda got, ref=ref: _same(got, ref)))
    # the pivot chain now fuses its products into sums, which a parent tree
    # without them rounds apart: old against new for the fm chain only
    for kernel in ("fm_chain3_scan",):
        for B, ps in CHAIN_SHAPES:
            ops, lvl = _chain_inputs(dev, 256, B, ps, 5 * B + ps)
            runs = {w: _chain_launcher(fns[kernel], ops)
                    for w, fns in (("old", old_fns), ("new", new_fns))}
            ref = _chain_plain(kernel, ops, lvl)
            rows.append((kernel, f"V=256 B={B} {_dt_label(ps)}", B, runs,
                         lambda got, ref=ref: _same(got, ref)))
    for V, B, ps in BIQUAD_AB:
        ops = _biquad_inputs(dev, V, B, ps, 17 * V + B)
        runs = {w: _biquad_launcher(fns["biquad_scan"], ops)
                for w, fns in (("old", old_fns), ("new", new_fns))}
        ref = iir.plain_biquad_scan(*ops)
        rows.append(("biquad_scan", f"V={V} B={B} "
                     f"{'planes' if ps else 'rows'}", B, runs,
                     lambda got, ref=ref: _same(got, ref)))
    for B in OPERATOR_SHAPES:
        ops = _operator_inputs(dev, 256, B, 19 * B)
        runs = {w: _operator_launcher(fns["fm_operator_scan"], ops)
                for w, fns in (("old", old_fns), ("new", new_fns))}
        ref = kfm.plain_fm_operator_scan(*ops)
        rows.append(("fm_operator_scan", f"V=256 B={B}", B, runs,
                     lambda got, ref=ref: _same(got, ref)))
    for regime, B in ADSR_AB:
        st, a_rows, sus = adsr_regime(regime, 256, B, seed=B, device=dev)
        runs = {w: _adsr_launcher(fns["adsr_scan"], st, a_rows, sus)
                for w, fns in (("old", old_fns), ("new", new_fns))}
        ref = kadsr.plain_adsr_scan(st, *a_rows, sus)
        rows.append(("adsr_scan", f"V=256 B={B} {regime}", B, runs,
                     lambda got, ref=ref: _same(got, ref)))
    for kernel, label, B, runs, plain_ok, *segs in rows:
        outs = {}
        for w, run in runs.items():
            outs[w] = [t.clone() for t in run()]
            torch.cuda.synchronize()
            if not plain_ok(outs[w]):
                raise SystemExit(f"{w} {kernel} {label}: not equal to (or "
                                 f"within the bounds of) the plain version")
        if not _same_nan(outs["new"], outs["old"]):
            raise SystemExit(f"{kernel} {label}: the new body's outputs "
                             f"differ from the old body's")
        t = {"old": [], "new": []}
        for _ in range(WINDOWS):
            for w in ("old", "new", "new", "old"):
                t[w].append(event_us(runs[w], LAUNCHES))
        o, n = statistics.median(t["old"]), statistics.median(t["new"])
        if segs:
            floor = chain_floor_us("parity", B, mhz, segs[0])
        elif kernel == "adsr_scan":   # the regime's stage, if it has one
            floor = chain_floor_us(ADSR_FLOOR.get(label.split()[-1], ""),
                                   B, mhz)
        else:
            floor = chain_floor_us(kernel, B, mhz)
        print(f"[ab] {kernel} {label}: old {o:.2f} us, new {n:.2f} us "
              f"(x{o / n:.2f}), new equal to old (torch.equal, NaN equal "
              f"to NaN) True"
              + (f", chain floor {floor:.2f} us" if floor else "")
              + f"; old {min(t['old']):.2f}-{max(t['old']):.2f}, new "
              f"{min(t['new']):.2f}-{max(t['new']):.2f} over {WINDOWS} "
              f"windows", flush=True)


# K17's rows: the models' lanes (the short wrap) and lanes off it (every
# p0 below 0: truncf), at B=1024 and 4096
FRACT_AB = tuple((lanes, B) for lanes in ("on", "off") for B in (1024, 4096))


def _ablation_entries(csrc: Path):
    """One tree's K16 and K17 entry points, typed."""
    return {
        "kabl": _typed(build.load_library("kabl", csrc).oscen_kabl,
                       [P] * 18 + [I] * 5 + [P]),
        "kabl_hmaj": _typed(build.load_library("kabl_hmaj", csrc)
                            .oscen_kabl_hmaj, [P] * 20 + [I] * 4 + [P]),
        "fract_abl": _typed(build.load_library("fractabl", csrc)
                            .oscen_fract_abl, [P] * 4 + [I] * 3 + [P]),
    }


def _kabl_launcher(fns, tool, name, x, B, cnt):
    """One launch of ``tool``'s variant ``name`` through one tree's entries
    (``fns``) on the inputs ``x``, its outputs preallocated and the mix's
    ticket counters ``cnt`` (zeroed, large enough for either tree: each
    launch leaves them zeroed); returns the tools' outputs as
    ``kabl.run_variant`` does."""
    run_ = kab.TOOLS[tool][name]
    body = run_.body
    dev = x["osc_re"].device
    H, V = x["osc_re"].shape
    outs = [torch.empty((H, V), device=dev) for _ in range(4)]
    step_o = torch.empty((1, V), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    if body in kab.HMAJ:
        ext, tiles = kab.HMAJ[body]
        y = torch.empty((B, 128 * tiles), device=dev)
        n_blk = V // kab.HMAJ_VOICES // tiles
        part = torch.empty((tiles * (n_blk + -(-n_blk // kab.MIX_GROUP)), B),
                           device=dev)
        planes = [x[k] for k in kab.HMAJ_PLANES]
        rows = [x["r1"].data_ptr(), x["r2"].data_ptr()] if ext \
            else [None, None]

        def run():
            _check(fns["kabl_hmaj"](
                *[t.data_ptr() for t in planes], x["step"].data_ptr(),
                *rows, y.data_ptr(), part.data_ptr(), cnt.data_ptr(),
                *[t.data_ptr() for t in outs], step_o.data_ptr(), int(ext),
                tiles, V, B, stream), f"kabl_hmaj {body}")
            return (y, *outs, step_o)
        return run
    sp = kab.VARIANTS[body]
    nw = kab.MMA_WARPS if kab.kernel_of(body) == kab.KERNEL_B \
        else kab.TICK_WARPS
    y = torch.empty((B,), device=dev)
    part = keep = None
    if sp.out == "store":
        n_blk = -(-V // nw)
        part = torch.empty((n_blk + -(-n_blk // kab.MIX_GROUP), B),
                           device=dev)
    else:
        keep = torch.empty((H, V), device=dev)
    planes = [x[k] for k in kab.PLANES]
    tbl = x["tbl"] if sp.rows in kab.ONEHOT_ROWS else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    def run():
        _check(fns["kabl"](
            *[t.data_ptr() for t in planes], x["step"].data_ptr(), ptr(tbl),
            y.data_ptr(), ptr(part), None if part is None else cnt.data_ptr(),
            ptr(keep), *[t.data_ptr() for t in outs], step_o.data_ptr(),
            list(kab.VARIANTS).index(body), V, B, run_.u, int(run_.cur_in),
            stream), f"kabl {body}")
        return (y[:, None], *outs, step_o)
    return run


def _fract_abl_launcher(fn, layout, p0, dt, B):
    """One launch of K17's ``layout`` through ``fn`` on preallocated
    outputs; returns (raw output, carry)."""
    V = p0.shape[1]
    shape = (B // kfa.S, 3 * kfa.S, V) if layout == "seg" else (B, 3, V)
    out = torch.empty(shape, device=p0.device)
    carry = torch.empty_like(p0)

    def run():
        _check(fn(p0.data_ptr(), dt.data_ptr(), out.data_ptr(),
                  carry.data_ptr(), kfa.LAYOUTS.index(layout), V, B,
                  torch.cuda.current_stream().cuda_stream),
               f"fract_abl {layout}")
        return out, carry
    return run


def ab_ablations(dev, old: Path):
    """K16 and K17 against the old tree's bodies, in turns (old, new, new,
    old) per window: every K16 body at its tool's inputs (H=32, V=256,
    B=1024; the one-hot rows on a seeded random table, as chip_smoke.py
    checks them) and K17's three layouts on the models' lanes and off
    them.  Each row first checks the new outputs equal to the old build's
    (``torch.equal``, every output: y too, since the segments keep every
    tick's harmonic and voice trees) and the state planes (K17: every
    output) equal to the plain version, then times; the new body's time
    segments per voice are printed beside it."""
    import importlib
    old_fns = _ablation_entries(old / "oscen_tpu_torch" / "csrc")
    new_fns = _ablation_entries(build.CSRC_DIR)
    cnt = torch.zeros(4096, dtype=torch.int32, device=dev)
    rows, seen = [], set()
    for tool, variants in kab.TOOLS.items():
        mod = importlib.import_module(f"oscen_tpu_torch.tools.{tool}")
        x = {k: torch.as_tensor(v, device=dev)
             for k, v in mod.inputs(1024).items()}
        if "tbl" in x:
            tbl = np.random.default_rng(1024).uniform(0, 0.5, x["tbl"].shape)
            x["tbl"] = torch.as_tensor(tbl.astype(np.float32),
                                       device=dev).to(torch.bfloat16)
        for name, run_ in variants.items():
            if run_.body in ("k3", "k1") or run_ in seen:
                continue
            seen.add(run_)
            runs = {w: _kabl_launcher(fns, tool, name, x, 1024, cnt)
                    for w, fns in (("old", old_fns), ("new", new_fns))}
            plain = kab.run_variant(tool, name, x, 1024, plain=True)
            segs = kab.segments(run_.body, 256, 1024, run_.u)
            rows.append((f"K16 {tool} {name} ({run_.body}, S={segs})",
                         runs, lambda got, ref=plain: _same(got[1:],
                                                            ref[1:])))
    for lanes, B in FRACT_AB:
        p0, dt = _fract_inputs(dev, lanes, B, 29 * B)
        for layout in kfa.LAYOUTS:
            runs = {w: _fract_abl_launcher(fns["fract_abl"], layout, p0, dt,
                                           B)
                    for w, fns in (("old", old_fns), ("new", new_fns))}
            ref = kfa.PLAIN[layout](p0, dt, B)
            rows.append((f"K17 fract_abl {layout} V=256 B={B} {lanes} lanes",
                         runs, lambda got, ref=ref: _bits_equal(got, ref)))
    for label, runs, plain_ok in rows:
        outs = {}
        for w, run in runs.items():
            outs[w] = [t.clone() for t in run()]
            torch.cuda.synchronize()
            if not plain_ok(outs[w]):
                raise SystemExit(f"{w} {label}: not equal to the plain "
                                 f"version")
        if not _same_nan(outs["new"], outs["old"]):
            raise SystemExit(f"{label}: the new body's outputs differ from "
                             f"the old body's")
        t = {"old": [], "new": []}
        for _ in range(WINDOWS):
            for w in ("old", "new", "new", "old"):
                t[w].append(event_us(runs[w], LAUNCHES))
        o, n = statistics.median(t["old"]), statistics.median(t["new"])
        print(f"[ab] {label}: old {o:.2f} us, new {n:.2f} us (x{o / n:.2f})"
              f", new equal to old (torch.equal, every output) True; old "
              f"{min(t['old']):.2f}-{max(t['old']):.2f}, new "
              f"{min(t['new']):.2f}-{max(t['new']):.2f} over {WINDOWS} "
              f"windows", flush=True)
    probe_fract_layout(dev)


def probe_fract_layout(dev):
    """K17 direct's body (``probe_fract_direct``) into the tool's [B, 3, V]
    and into K12's [3, B, V], beside K17 direct and K12 (``fract_phase3``),
    in turns, on the models' lanes at B=1024 and 4096: what the direct
    layout's delta against K12 is made of.  Each output first checked
    equal to K12's on its bit patterns."""
    fn = _probe_lib().probe_fract_direct
    for B in (1024, 4096):
        p0, dt = _fract_inputs(dev, "on", B, 31 * B)
        ref = kfm.fract_phase3(p0, dt, B)
        runs = {}
        for k12, name in ((0, "[B, 3, V]"), (1, "[3, B, V]")):
            out = torch.empty((3 * B * 256,), device=dev)
            carry = torch.empty_like(p0)

            def run(k12=k12, out=out, carry=carry):
                _check(fn(k12, p0.data_ptr(), dt.data_ptr(), out.data_ptr(),
                          carry.data_ptr(), 256, B,
                          torch.cuda.current_stream().cuda_stream),
                       "probe_fract_direct")
                o = out.view(3, B, 256) if k12 else \
                    out.view(B, 3, 256).transpose(0, 1)
                return o[0], o[1], o[2], carry
            runs[f"direct body into {name}"] = run
        runs["K17 direct"] = lambda: kfa.fract_layout("direct", p0, dt, B)
        runs["K12"] = lambda: kfm.fract_phase3(p0, dt, B)
        for label, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            if not _bits_equal(got, ref):
                raise SystemExit(f"K17 {label} B={B}: not equal to K12")
        t = {k: [] for k in runs}
        for _ in range(WINDOWS):
            for k in list(runs) + list(runs)[::-1]:
                t[k].append(event_us(runs[k], LAUNCHES))
        print(f"[probe] K17 direct by output layout, V=256 B={B}, models' "
              f"lanes, equal to K12 (bit patterns): " + "; ".join(
                  f"{k} {statistics.median(v):.2f} us" for k, v in
                  t.items()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="a tree of the parent commit: time its iir.cu, "
                         "phase.cu, additive.cu, fm.cu, adsr.cu, kabl.cu, "
                         "kabl_hmaj.cu and fractabl.cu against the "
                         "package's")
    ap.add_argument("--ablations", action="store_true",
                    help="with --old: the K16 / K17 rows alone (no "
                         "latency, probe or other ab rows)")
    args = ap.parse_args(argv)
    if args.ablations and args.old is None:
        ap.error("--ablations compares against --old")
    if not torch.cuda.is_available():
        ap.error("no CUDA card: the probes time the card")
    dev = torch.device("cuda")
    mhz = sm_clock_mhz(dev)
    print(f"[scanprobe] {card()}; SM clock under load {mhz:.0f} MHz",
          flush=True)
    if args.ablations:
        ab_ablations(dev, args.old)
        return 0
    latency(dev)
    probe(dev, mhz)
    probe_adsr(dev, mhz)
    if args.old is not None:
        ab(dev, args.old, mhz)
        ab_ablations(dev, args.old)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
