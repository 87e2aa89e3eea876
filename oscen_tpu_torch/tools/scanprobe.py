"""Where the scans' and the additive voice's time goes, and the redesigns
against the old bodies, on the card.

    python -m oscen_tpu_torch.tools.scanprobe [--old DIR]

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
- ``ab`` (with ``--old DIR``, a tree of the parent commit, e.g. unpacked
  by ``git archive``): that tree's ``csrc/iir.cu``, ``csrc/phase.cu`` and
  ``csrc/additive.cu`` and the package's own, built alike, timed in turns
  (old, new, new, old) per window at the main paths' shapes: K7 V=256 at
  B=1024 and 4096 (row and per-sample coefficients) and V=1; K8 V=2 and 1,
  rows and a sweep; K6 V=256 at 1024 and 4096 steps and V=1 at 4096 and
  16384 (the 4x saturator's lane at B=1024 and 4096); K1 v4 V=256 with
  the mix at B=1024 and 4096 and without it at 1024.  Each row first
  checks that the new outputs equal the old build's on the same inputs
  (``torch.equal``, every output) and the plain version (the scans
  ``torch.equal``; K1's state planes ``torch.equal``, y within the
  kernel's bound), and only then times.  The old ``additive.cu``'s local
  memory (LDL / STL in its SASS) is counted beside the new one's.

Times are device µs per launch from CUDA events around 20 back-to-back
launches queued behind a ~1 ms sleep kernel (so the host's enqueueing
stays off the card's clock), the median over 5 windows, beside each
call's chain floor (``tools.chain_floor_us`` at the SM clock
``tools.sm_clock_mhz`` reads).  On the card only.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import statistics
from pathlib import Path

import numpy as np
import torch

from . import card, chain_floor_us, sass_counts, sm_clock_mhz
from ..ops.cuda import additive as add
from ..ops.cuda import build, iir
from ..ops.cuda import phase as kphase

WINDOWS = 5
LAUNCHES = 20
P, I = ctypes.c_void_p, ctypes.c_int
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
# K1's: the piano's 256 voices (with the mix, and without at 1024)
ADD_SHAPES = ((1024, True), (4096, True), (1024, False))


def event_us(fn) -> float:
    """Device µs per launch: CUDA events around LAUNCHES launches of
    ``fn``, queued behind a ~1 ms sleep on the card."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    a.record()
    for _ in range(LAUNCHES):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / LAUNCHES


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
    return lib


def _entries(csrc: Path):
    """The C entry points of one tree's sources, typed: (K7, K8, K6, K1)."""
    lib = build.load_library("iir", csrc)
    tpt = _typed(lib.oscen_tpt_svf_scan, [P] * 9 + [I] * 5 + [P])
    lp18 = _typed(lib.oscen_lp18_scan, [P] * 6 + [I] * 4 + [P])
    ph = _typed(build.load_library("phase", csrc).oscen_phase_scan,
                [P] * 4 + [I] * 2 + [P])
    k1 = _typed(build.load_library("additive", csrc).oscen_additive_v4,
                [P] * 17 + [I] * 5 + [P])
    return tpt, lp18, ph, k1


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


def _additive_inputs(dev, V=256, seed=0):
    """The piano's shapes: seeded planes, steps 0..64 with the edges."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 0.2, (32, V))
    step = rng.integers(0, 65, (V,)).astype(np.float32)
    step[:3] = (0.0, 64.0, 33.0)
    planes = [rng.normal(size=(32, V)), rng.normal(size=(32, V)),
              np.cos(th), np.sin(th), rng.uniform(0, 1, (32, V)),
              rng.uniform(0, 1, (32, V)), rng.uniform(0.9, 1.0, (32, V))]
    return ([torch.as_tensor(np.asarray(p, np.float32), device=dev)
             for p in planes], torch.as_tensor(step, device=dev))


def _additive_launcher(fn, planes, step, B, with_mix, tail=()):
    """One K1 launch of ``fn`` (the C entry, ``csrc/additive.cu``'s
    arguments) on preallocated outputs; ``tail`` goes before the stream
    (the segment entry's version and count)."""
    V = planes[0].shape[1]
    dev = planes[0].device
    sub = add.subgroup_len(B, "v4")
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
                  torch.cuda.current_stream().cuda_stream), "additive v4")
        return (y, *outs, step_o)
    return run


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _additive_ok(got, planes, step, B, with_mix):
    """K1's bounds against its plain version: state planes torch.equal, y
    within 5e-5 (x sqrt(V) with the mix)."""
    ref = add.plain_block(*planes, step, B, with_mix, "v4")
    tol = 5e-5 * (math.sqrt(planes[0].shape[1]) if with_mix else 1.0)
    return (float((got[0] - ref[0]).abs().max()) <= tol
            and _same(got[1:], ref[1:]))


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
            res[i].append(event_us(row[-1]))
    for i, (kernel, label, B, name, _) in enumerate(rows):
        us = statistics.median(res[i])
        print(f"[{tag}] {kernel} {label} {name}: {us:.2f} us, "
              f"{us * mhz / B:.1f} cycles per step at {mhz:.0f} MHz",
              flush=True)


def probe(dev, mhz):
    lib = _probe_lib()
    shipped_k6 = _entries(build.CSRC_DIR)[2]
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
    _print_rows(rows, mhz)


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
    rng = np.random.default_rng(1)
    plain = {"tpt_svf_scan": iir.plain_tpt_svf_scan,
             "lp18_scan": iir.plain_lp18_scan}
    rows = []
    for kernel, label, B, ops, strides in _cases(dev, rng):
        k = 0 if kernel == "tpt_svf_scan" else 1
        runs = {w: _launcher(fns[k], kernel, ops, strides)
                for w, fns in (("old", old_fns), ("new", new_fns))}
        ref = plain[kernel](*ops)
        rows.append((kernel, label, B, runs, lambda got, ref=ref:
                     _same(got, ref)))
    for V, B in PHASE_SHAPES:
        p0, dt = _phase_inputs(dev, V, B, 7 * V + B)
        runs = {w: _phase_launcher(fns[2], p0, dt)
                for w, fns in (("old", old_fns), ("new", new_fns))}
        ref = kphase.plain_phase_scan(p0, dt)
        rows.append(("phase_scan", f"V={V} B={B}", B, runs,
                     lambda got, ref=ref: _same(got, ref)))
    planes, step = _additive_inputs(dev)
    for B, with_mix in ADD_SHAPES:
        runs = {w: _additive_launcher(fns[3], planes, step, B, with_mix)
                for w, fns in (("old", old_fns), ("new", new_fns))}
        rows.append(("additive_v4", f"V=256 B={B}"
                     + (" with_mix" if with_mix else ""), B, runs,
                     lambda got, B=B, m=with_mix:
                     _additive_ok(got, planes, step, B, m)))
    for kernel, label, B, runs, plain_ok in rows:
        outs = {}
        for w, run in runs.items():
            outs[w] = [t.clone() for t in run()]
            torch.cuda.synchronize()
            if not plain_ok(outs[w]):
                raise SystemExit(f"{w} {kernel} {label}: not equal to (or "
                                 f"within the bounds of) the plain version")
        if not _same(outs["new"], outs["old"]):
            raise SystemExit(f"{kernel} {label}: the new body's outputs "
                             f"differ from the old body's")
        t = {"old": [], "new": []}
        for _ in range(WINDOWS):
            for w in ("old", "new", "new", "old"):
                t[w].append(event_us(runs[w]))
        o, n = statistics.median(t["old"]), statistics.median(t["new"])
        floor = chain_floor_us(kernel, B, mhz)
        print(f"[ab] {kernel} {label}: old {o:.2f} us, new {n:.2f} us "
              f"(x{o / n:.2f}), new equal to old (torch.equal) True"
              + (f", chain floor {floor:.2f} us" if floor else "")
              + f"; old {min(t['old']):.2f}-{max(t['old']):.2f}, new "
              f"{min(t['new']):.2f}-{max(t['new']):.2f} over {WINDOWS} "
              f"windows", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="a tree of the parent commit: time its iir.cu, "
                         "phase.cu and additive.cu against the package's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("no CUDA card: the probes time the card")
    dev = torch.device("cuda")
    mhz = sm_clock_mhz(dev)
    print(f"[scanprobe] {card()}; SM clock under load {mhz:.0f} MHz",
          flush=True)
    latency(dev)
    probe(dev, mhz)
    if args.old is not None:
        ab(dev, args.old, mhz)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
