"""Where K7's and K8's time per step goes, and the redesign against the old
bodies, on the card.

    python -m oscen_tpu_torch.tools.scanprobe [--old DIR]

Three parts, one line each:

- ``latency``: cycles per dependent op on one thread (``csrc/scanprobe.cu``
  ``lat_kernel``): FMUL + FADD, DFMA, the float32 -> float64 -> float32
  round trip with a DADD, a shared-memory load, DMUL, FADD + IEEE
  division;
- ``probe``: the old bodies of ``tpt_svf_scan`` (K7) and ``lp18_scan``
  (K8) with one cost taken out at a time (x from a register, the tanh as
  the identity, the division as a product with a hoisted reciprocal,
  other unrolls), row coefficients, at the main paths' shapes;
- ``ab`` (with ``--old DIR``, a tree of the parent commit, e.g. unpacked
  by ``git archive``): the old ``csrc/iir.cu`` of that tree and the
  package's own, built alike, timed in turns (old, new, new, old) per
  window at the main paths' shapes (K7 V=256 at B=1024 and 4096, row and
  per-sample coefficients, V=1 for the echo; K8 V=2 and 1 at B=1024 and
  4096, rows and a sweep), both checked equal to the plain version first.

Times are device µs per launch from CUDA events around 20 back-to-back
launches (``tools.chain_us``; the profiler drops device time late in long
runs), the median over 5 windows, beside each call's chain floor
(``tools.chain_floor_us`` at the SM clock ``tools.sm_clock_mhz`` reads).
On the card only.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
from pathlib import Path

import numpy as np
import torch

from . import card, chain_floor_us, chain_us, sm_clock_mhz
from ..ops.cuda import build, iir

WINDOWS = 5
TPT_PROBES = {0: "as is", 1: "x from a register", 2: "unroll 16",
              3: "unroll 1"}
LP18_PROBES = {0: "(a) as is", 1: "(b) x from a register",
               2: "(c) tanh = identity", 3: "(d) division = product",
               4: "b+c+d, the bare chain", 5: "unroll 16",
               6: "c+d, loads only"}
LAT = ("FMUL+FADD", "DFMA", "F2F+DADD+F2F", "LDS", "DMUL", "FADD+div")


def event_us(fn) -> float:
    """Device µs per launch: CUDA events around 20 launches of ``fn``."""
    return chain_us(lambda _: fn(), None, 20)


def _probe_lib():
    lib = build.load_library("scanprobe")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_tpt.argtypes = [I] + [P] * 9 + [I] * 5 + [P]
    lib.probe_lp18.argtypes = [I] + [P] * 6 + [I] * 4 + [P]
    lib.probe_lat.argtypes = [P, P, I]
    for fn in (lib.probe_tpt, lib.probe_lp18, lib.probe_lat):
        fn.restype = I
    return lib


def _entries(csrc: Path):
    """The two C entry points of ``csrc/iir.cu`` (old or new), typed."""
    lib = build.load_library("iir", csrc)
    P, I = ctypes.c_void_p, ctypes.c_int
    tpt, lp18 = lib.oscen_tpt_svf_scan, lib.oscen_lp18_scan
    tpt.argtypes = [P] * 9 + [I] * 5 + [P]
    lp18.argtypes = [P] * 6 + [I] * 4 + [P]
    tpt.restype = lp18.restype = I
    return tpt, lp18


def _cases(dev, rng):
    """(kernel, label, B, operands, strides) at the main paths' shapes."""
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
        rc = fn(*[t.data_ptr() for t in ops], *[t.data_ptr() for t in outs],
                V, B, *strides, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{kernel} launch failed ({rc})")
        return outs
    return run


def latency(dev):
    lib = _probe_lib()
    out = torch.zeros(4, device=dev)
    cyc = torch.zeros(8, dtype=torch.int64, device=dev)
    n = 4096
    if lib.probe_lat(out.data_ptr(), cyc.data_ptr(), n) != 0:
        raise RuntimeError("lat_kernel launch failed")
    c = (cyc.cpu().numpy()[:len(LAT)] / n).tolist()
    print("[latency] cycles per dependent step: " + ", ".join(
        f"{k} {v:.1f}" for k, v in zip(LAT, c)), flush=True)


def probe(dev, mhz):
    lib = _probe_lib()
    rng = np.random.default_rng(0)
    rows = []
    for kernel, label, B, ops, strides in _cases(dev, rng):
        if "rows" not in label:
            continue
        table = TPT_PROBES if kernel == "tpt_svf_scan" else LP18_PROBES
        entry = lib.probe_tpt if kernel == "tpt_svf_scan" else lib.probe_lp18
        for var, name in table.items():
            run = _launcher(lambda *a, e=entry, var=var: e(var, *a), kernel,
                            ops, strides)
            rows.append((kernel, label, B, name, run))
    res = {i: [] for i in range(len(rows))}
    for _ in range(WINDOWS):
        for i, (kernel, *_, run) in enumerate(rows):
            res[i].append(event_us(run))
    for i, (kernel, label, B, name, _) in enumerate(rows):
        us = statistics.median(res[i])
        print(f"[probe] {kernel} {label} {name}: {us:.2f} us, "
              f"{us * 1e-6 * mhz * 1e6 / B:.1f} cycles per step at "
              f"{mhz:.0f} MHz", flush=True)


def ab(dev, old: Path, mhz):
    """Old and new bodies in turns (old, new, new, old) per window."""
    old_fns = _entries(old / "oscen_tpu_torch" / "csrc")
    new_fns = _entries(build.CSRC_DIR)
    rng = np.random.default_rng(1)
    plain = {"tpt_svf_scan": iir.plain_tpt_svf_scan,
             "lp18_scan": iir.plain_lp18_scan}
    for kernel, label, B, ops, strides in _cases(dev, rng):
        k = 0 if kernel == "tpt_svf_scan" else 1
        runs = {w: _launcher(fns[k], kernel, ops, strides)
                for w, fns in (("old", old_fns), ("new", new_fns))}
        ref = plain[kernel](*ops)
        for w, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise SystemExit(f"{w} {kernel} {label}: not equal to the "
                                 f"plain version")
        t = {"old": [], "new": []}
        for _ in range(WINDOWS):
            for w in ("old", "new", "new", "old"):
                t[w].append(event_us(runs[w]))
        o, n = statistics.median(t["old"]), statistics.median(t["new"])
        floor = chain_floor_us(kernel, B, mhz)
        print(f"[ab] {kernel} {label}: old {o:.2f} us, new {n:.2f} us "
              f"(x{o / n:.2f}), chain floor {floor:.2f} us; old "
              f"{min(t['old']):.2f}-{max(t['old']):.2f}, new "
              f"{min(t['new']):.2f}-{max(t['new']):.2f} over "
              f"{WINDOWS} windows", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="a tree of the parent commit: time its iir.cu "
                         "against the package's")
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
