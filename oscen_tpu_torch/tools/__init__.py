"""Ablation drivers on the card: the port's counterparts of the JAX
package's ``tools/kabl*.py`` (K16, attributing the additive kernels K1 and
K3) and ``tools/fractabl*.py`` (K17, attributing ``fract_phase3``, K12).

Each module builds the inputs its TPU twin builds (the same numpy seed and
formulas; ``fractabl``'s JAX random draws become numpy draws of the same
distributions), runs every variant once and prints a parity line, then
times the variants round-robin over 7 windows:

- device µs per launch, from ``torch.profiler``'s kernel time;
- wall µs per block, from CUDA events around a chain of n launches with
  the state fed back.

This replaces the TPU tools' protocol (host spans of a jitted scan of n
and of n' blocks, differenced): CUDA events time the card's own clock, and
the profiler separates the kernel from the launch overhead.  Run from the
repository root, on the card unless ``--device cpu`` is given (the CPU runs
the plain versions, prints the parity line and times nothing):

    python -m oscen_tpu_torch.tools.kabl4 [variants...] [--device cpu]
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

WINDOWS = 7
# the chain floor of a one-thread-per-lane scan: B x the dependent ops on
# its loop-carried cycle x CHAIN_CYCLES each, at the SM clock nvidia-smi
# reads under load (``sm_clock_mhz``).  Counted from each kernel's loop in
# oscen_tpu_torch/csrc (a select, a floor or a clamp counts 1; a division,
# a tanh and the FM sine's polynomial count as their ops: the division 1,
# the tanh 1, sin_turns 12): phase 3 (add, floor, subtract); TPT 7 (the
# z1 cycle: - z1, * h, * g, + z0, * g, + z1, + low); ADSR 6 (the level:
# subtract, multiply, add, clamp 2, stage select); fract 3; the FM chains
# 15 (an operator's own feedback: * fb, + phase, sin 12, * env); the FM
# operator 17 (* fb, + pm, + phase, sin 12, * env, * lvl); LP18 8 (* h,
# - x, - z1, - z2, the division, * g, + z0, the tanh); biquad 6 (+ v1,
# * a1, -, + v2, the snap 2); the allpass cascade 3 (each stage's own
# cycle; the stages follow each other within the sample).  The additive
# kernels' warps (a voice's time segment, one lane per harmonic) carry
# per tick: v4, v3, v2 and the epilogue 2 (the running power m^(j+1):
# * m, then the complex sum; the envelope product p: * f, then the wrap
# select; v3's and v2's step counter: + 1, then its select), parity 3 (cur:
# * (1 - tau), + tgt * tau, the interp select); their chain is the ticks
# one warp runs in order, B / segments (``additive.segments``).  The
# ablation bodies have none.
CHAIN_OPS = {"phase_scan": 3, "tpt_svf_scan": 7, "adsr_scan": 6,
             "fract_phase3": 3, "fm_chain3_scan": 15,
             "pivot_chain3_scan": 15, "fm_operator_scan": 17,
             "lp18_scan": 8, "biquad_scan": 6, "allpass_cascade_scan": 3,
             "v4": 2, "v3": 2, "v2": 2, "v4_epilogue": 2, "parity": 3}
CHAIN_CYCLES = 4   # dependent float32 issue latency on Hopper


def chain_floor_us(kernel: str, B: int, mhz: float) -> Optional[float]:
    """The chain floor of ``kernel`` over ``B`` steps in order (one lane's,
    or one additive warp's ticks) at ``mhz``, in µs (None: no serial chain
    per lane)."""
    if kernel not in CHAIN_OPS:
        return None
    return B * CHAIN_OPS[kernel] * CHAIN_CYCLES / mhz


def sm_clock_mhz(dev) -> float:
    """nvidia-smi's SM clock while ~0.7 s of ``lp18_scan`` launches run on
    ``dev`` (the card's clock under load)."""
    from ..ops.cuda import iir
    x = torch.zeros(4096, 2, device=dev)
    r = torch.full((2,), 0.1, device=dev)
    z = torch.zeros(3, 2, device=dev)
    for _ in range(2000):
        iir.lp18_scan(x, r, r, z)
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout
    torch.cuda.synchronize()
    return float(out.split()[0])


def sass_counts(lib, ops: Sequence[str]) -> Dict[str, Dict[str, int]]:
    """Per kernel function of the built library ``lib`` (a path), its
    instruction count (``instr``) and how many of its instructions contain
    each of ``ops`` (e.g. "LDL", "SHFL"), from ``cuobjdump -sass``; raises
    if cuobjdump or the library is missing."""
    import re
    import shutil
    from pathlib import Path
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists() or not Path(lib).exists():
        raise RuntimeError(f"no cuobjdump or no {lib} to count SASS in")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    counts: Dict[str, Dict[str, int]] = {}
    fn = None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(("instr",) + tuple(ops), 0)
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/", ln):
            counts[fn]["instr"] += 1
            for op in ops:
                counts[fn][op] += op in ln
    return counts


def parse_args(argv, variants: Sequence[str], doc: str):
    """(variants to run, device) from the command line."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(variants),
                    help=f"any of {', '.join(variants)}")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    bad = [v for v in args.variants if v not in variants]
    if bad:
        ap.error(f"unknown variants {bad}; choose from {list(variants)}")
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA card: the drivers time the card (give --device "
                 "cpu for the parity line alone)")
    return args


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
        else torch.cuda.get_device_name(0)


def uniform_inputs(H=32, V=256, seed=0):
    """The planes of ``tools/kabl.py:147-157`` (kabl-kabl5): harmonic
    rotations of 55 Hz multiples, a fresh oscillator, envelopes at
    ``cur * 0.999``, steps 0-63; returns (numpy dict, ``th``)."""
    rng = np.random.default_rng(seed)
    th = (2 * np.pi * (55.0 * (1 + rng.integers(0, 48, V))[None, :]
                       * np.arange(1, H + 1)[:, None]) / 48000.0)
    cur = rng.uniform(0.01, 0.3, (H, V)).astype(np.float32)
    planes = dict(osc_re=np.ones((H, V)), osc_im=np.zeros((H, V)),
                  mul_re=np.cos(th), mul_im=np.sin(th), cur=cur,
                  tgt=cur * np.float32(0.999),
                  mult=np.full((H, V), 0.999),
                  step=rng.integers(0, 64, (1, V)))
    return {k: np.asarray(v, np.float32) for k, v in planes.items()}, th


def device_ms(fn: Callable[[], object], reps: int = 20,
              kernel: Optional[str] = None, top: Optional[int] = None,
              note: Callable[[str], None] = print):
    """Device time per call from ``torch.profiler``, in ms: that of the
    kernels whose name contains ``kernel`` per launch the profiler recorded
    (late in a long run it keeps only some; ``note`` is told when it kept
    fewer than ``reps``), or with ``kernel=None`` the sum over all device
    activity per call (the busy time).  With ``top``, returns (busy ms, the
    ``top`` largest activities as (name, ms per call, launches per call),
    device activities per call).  ``fn`` runs twice first, to warm up."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for attempt in range(2):   # profile again if the first saw nothing
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, rows, seen = 0.0, [], 0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and (kernel is None or kernel in e.key):
                total += us
                seen += e.count
                rows.append((e.key, us / reps / 1e3, e.count / reps))
        if total > 0:
            break
        if attempt == 0:
            note(f"the profiler saw no device time ({kernel or 'all'}); "
                 f"profiling again")
    if total <= 0:
        raise RuntimeError(f"the profiler saw no device time for "
                           f"{kernel or 'any kernel'}")
    if top is not None:
        rows.sort(key=lambda r: -r[1])
        return total / reps / 1e3, rows[:top], sum(r[2] for r in rows)
    if seen != reps:
        note(f"the profiler recorded {seen} of {reps} launches of {kernel}")
    return total / seen / 1e3


def device_us(fn: Callable[[], object], kernel: str, reps: int = 20) -> float:
    """Device time per launch of the kernels whose name contains
    ``kernel`` (``device_ms``), in µs; ``fn`` launches one."""
    return device_ms(fn, reps, kernel=kernel, note=lambda _: None) * 1e3


def chain_us(step: Callable, state, n: int = 64) -> float:
    """Wall µs per block on the card's clock: CUDA events around ``n``
    launches of ``state = step(state)``."""
    state = step(state)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        state = step(state)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / n


def round_robin(variants: Sequence[str], measure: Callable[[str], tuple]
                ) -> Dict[str, List[tuple]]:
    """``measure(variant)`` for every variant in turn, ``WINDOWS`` times,
    so that drift on the card hits every variant alike."""
    res: Dict[str, List[tuple]] = {v: [] for v in variants}
    for _ in range(WINDOWS):
        for v in variants:
            res[v].append(measure(v))
    return res


def report(res: Dict[str, List[tuple]], base: str, labels=("device",
                                                            "wall")):
    """Print median and min of each measure and the median's delta
    against ``base``."""
    med = {v: [statistics.median(x[i] for x in xs) for i in
               range(len(labels))] for v, xs in res.items()}
    ref = med.get(base)
    print(f"[timing] {card()}; µs per block, median and min over "
          f"{len(next(iter(res.values())))} windows"
          + (f", delta of the median against {base}" if ref else ""))
    for v, xs in res.items():
        cols = []
        for i, lab in enumerate(labels):
            d = (f" ({med[v][i] - ref[i]:+.2f})" if ref else "")
            cols.append(f"{lab} med {med[v][i]:8.2f} min "
                        f"{min(x[i] for x in xs):8.2f}{d}")
        print(f"{v:9s}: " + "  ".join(cols), flush=True)
    return med


def kabl_main(tool: str, argv, doc: str, make_inputs: Callable) -> int:
    """The K16 drivers' common run: parity, then round-robin timing.

    ``make_inputs(B)`` gives the tool's inputs as numpy arrays.  The parity
    line holds each variant's kernel against its plain version on the card
    (y max abs, state planes ``torch.equal``), and its y against the
    baseline (``v3b``, or kabl's ``full``, kabl2's ``recur``) with the
    scale, as kabl5 and kabl6 print it."""
    from ..ops.cuda import kabl
    variants = list(kabl.TOOLS[tool])
    args = parse_args(argv, variants, doc)
    B = 1024
    x = make_inputs(B)
    x = {k: torch.as_tensor(v, device=args.device) for k, v in x.items()}
    if "tbl" in x:
        x["tbl"] = x["tbl"].to(torch.bfloat16)
    base = next(v for v in ("v3b", "full", "recur") if v in variants)
    ref = kabl.run_variant(tool, base, x, B)[0]
    scale = float(ref.abs().max())
    card_run = args.device == "cuda"
    for v in args.variants:
        out = kabl.run_variant(tool, v, x, B)
        line = f"[{tool}] {v}: "
        if card_run:
            plain = kabl.run_variant(tool, v, x, B, plain=True)
            err = float((out[0] - plain[0]).abs().max())
            same = all(torch.equal(a, b) for a, b in zip(out[1:], plain[1:]))
            line += (f"kernel against plain y max abs {err:.3e}, state "
                     f"planes equal {same}; ")
        y = out[0] if out[0].shape[1] == 1 else out[0][:, ::128].sum(
            dim=1, keepdim=True)
        line += (f"y against {base} max abs "
                 f"{float((y - ref).abs().max()):.3e} (scale {scale:.3e})")
        print(line, flush=True)
    if not card_run:
        print(f"[{tool}] timing needs a CUDA card")
        return 0

    def kernel_name(v):
        body = kabl.TOOLS[tool][v].body
        return ("additive_closed_kernel" if body in ("k3", "k1")
                else kabl.kernel_of(body) + "_kernel")

    def step(v):
        def fn(st):
            out = kabl.run_variant(tool, v, st, B)
            return dict(st, osc_re=out[1], osc_im=out[2], cur=out[3],
                        tgt=out[4], step=out[5])
        return fn

    def measure(v):
        return (device_us(lambda: kabl.run_variant(tool, v, x, B),
                          kernel_name(v)),
                chain_us(step(v), x))
    report(round_robin(args.variants, measure), base)
    return 0
