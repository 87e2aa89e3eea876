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
# z1 cycle: - z1, * h, * g, + z0, * g, + z1, + low); ADSR in attack and
# decay 3 (adsr.cu's fast body as ptxas builds it: tg - level, * c, then
# + level with the clamp folded in, FADD.SAT, under the stage's select as
# its predicate), in release 4 (``adsr_release``: the quotient's a * y,
# a - m q0, q0 + r y, then + level as FADD.SAT); fract 3; the FM chains
# 15 (an operator's own feedback: * fb, + phase, sin 12, * env); the FM
# operator 17 (* fb, + pm, + phase, sin 12, * env, * lvl); LP18 8 (* h,
# - x, - z1, - z2, the division, * g, + z0, the tanh); biquad 6 (+ v1,
# * a1, -, + v2, the snap 2); the allpass cascade 3 (each stage's own
# cycle: its stages run a sample apart, csrc/iir.cu).  The additive
# kernels' warps (a voice's time segment, one lane per harmonic) carry
# per tick: v4, v3, v2 and the epilogue 2 (the running power m^(j+1):
# * m, then the complex sum; the envelope product p: * f, then the wrap
# select; v3's and v2's step counter: + 1, then its select), parity 3 (cur:
# * (1 - tau), + tgt * tau, the interp select); their chain is the ticks
# one warp runs in order, B / segments (``additive.segments``).  A parity
# segment first walks the rotation from tick 0 (``REPLAY_OPS``: * m, then
# the complex sum), so the last segment's warp carries 2 ops over the
# B - B / segments ticks before it.  K17's ``fract_abl`` walks K12's
# fract chain (3).  K16's tick-major bodies (``kabl_tick``, ``kabl_mma``)
# carry v3's 2 over each time segment's ticks; its harmonic-major body
# (``kabl_hmaj``) 1 (a thread's accumulation over the harmonics, one add a
# harmonic for each of a subgroup's ticks in parallel: SUB adds a subgroup
# of SUB ticks).
CHAIN_OPS = {"phase_scan": 3, "tpt_svf_scan": 7, "adsr_scan": 3,
             "adsr_release": 4,
             "fract_phase3": 3, "fract_abl": 3, "fm_chain3_scan": 15,
             "pivot_chain3_scan": 15, "fm_operator_scan": 17,
             "lp18_scan": 8, "biquad_scan": 6, "allpass_cascade_scan": 3,
             "v4": 2, "v3": 2, "v2": 2, "v4_epilogue": 2, "parity": 3,
             "kabl_tick": 2, "kabl_mma": 2, "kabl_hmaj": 1}
REPLAY_OPS = {"parity": 2}
CHAIN_CYCLES = 4   # dependent float32 issue latency on Hopper


def chain_floor_us(kernel: str, B: int, mhz: float,
                   segs: int = 1) -> Optional[float]:
    """The chain floor of ``kernel`` over a block of ``B`` steps (one
    lane's, or the last of an additive voice's ``segs`` time segments: its
    B / segs ticks, after parity's replay of the ticks before them) at
    ``mhz``, in µs (None: no serial chain per lane)."""
    if kernel not in CHAIN_OPS:
        return None
    own = B // segs
    ops = own * CHAIN_OPS[kernel] + (B - own) * REPLAY_OPS.get(kernel, 0)
    return ops * CHAIN_CYCLES / mhz


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


def event_us(fn: Callable[[], object], n: int = 20) -> float:
    """Device µs per call: CUDA events around ``n`` back-to-back calls of
    ``fn`` queued behind a sleep on the card of ~100 µs per call, at least
    ~1 ms (so the host's enqueueing, a wrapper's ~50 µs a call included,
    stays off the card's clock)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(max(2_000_000, 200_000 * n))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / n


def device_ms(fn: Callable[[], object], reps: int = 20,
              kernel: Optional[str] = None, top: Optional[int] = None,
              note: Callable[[str], None] = print):
    """Device time per call from ``torch.profiler``, in ms: that of the
    kernels whose name contains ``kernel`` per launch the profiler recorded
    (late in a long run it keeps only some, and at last none: ``note`` is
    told when it kept fewer than ``reps``, and with none the call is timed
    by ``event_us`` instead), or with ``kernel=None`` the sum over all
    device activity per call (the busy time).  With ``top``, returns (busy
    ms, the ``top`` largest activities as (name, ms per call, launches per
    call), device activities per call).  ``fn`` runs twice first, to warm
    up."""
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
        if kernel is not None and top is None:
            note(f"the profiler saw no device time ({kernel}) again; timed "
                 f"with CUDA events behind a sleep instead")
            return event_us(fn, reps) / 1e3
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


# K11's regimes: what its design treats apart (csrc/adsr.cu), each a block
# of state7 and sus_param that adsr_scan starts from.  "sustain", "idle"
# and "held_mix" hold from t = 0 (every voice in SUSTAIN, IDLE, or one of
# the two); "gate_on" runs attack and decay into sustain within ~50-210
# samples; "edge" has decaying voices whose stage ends at a group's or a
# chunk's edge (rem 1, 8, 9, 31, 32, 33, 64, 65: the last step of chunk 0
# at rem 32, the first of chunk 1 at 33) beside sustained ones; "one_decay"
# one voice of every 32 in a long decay, the rest sustained (the warp stays
# serial); "release_idle" releases every voice to IDLE within ~160
# samples; "ramp" a per-sample sus_param ramp over voices in attack, decay,
# sustain and a long release; "decay" and "release" a whole block of
# B <= 4096 in decay or release (the fm synth's 0.1-0.2 s decays and 0.3-0.5
# s releases, models/fm_synth.py).
ADSR_REGIMES = ("sustain", "idle", "held_mix", "gate_on", "edge",
                "one_decay", "release_idle", "ramp", "decay", "release")
# attack, decay, sustain, release (s): tests/test_pallas.py:274-280's short
# stages, and the fm synth's envelope bank
_ADSR_SHORT = ((0.0005, 0.0010, 0.60, 0.0015), (0.0020, 0.0005, 0.25, 0.0008),
               (0.0010, 0.0030, 0.90, 0.0030))
_ADSR_LONG = ((0.01, 0.1, 0.7, 0.3), (0.01, 0.1, 0.7, 0.3),
              (0.01, 0.2, 0.8, 0.5), (0.01, 0.2, 0.5, 0.3))
_ADSR_EDGE_REM = (1.0, 8.0, 9.0, 31.0, 32.0, 33.0, 64.0, 65.0)


def adsr_regime(name: str, V: int, B: int, seed: int = 0, device="cpu"):
    """(state7 ``[7, V]``, the rows (a_n, d_n, r_n, a_c, d_c) ``[V]``,
    sus_param ``[B, V]``) of K11's regime ``name`` (``ADSR_REGIMES``) at 48
    kHz, made from ``seed``: the parameters tiled over the voices and
    perturbed by up to +-10%, velocities in [0.6, 1], the rows as
    ``nodes/envelope.py::_cached_steps`` makes them."""
    from ..nodes.envelope import _cached_steps
    if name not in ADSR_REGIMES:
        raise ValueError(f"unknown regime {name!r}")
    rng = np.random.default_rng(seed)
    short = name in ("gate_on", "edge", "release_idle")
    base = np.array(_ADSR_SHORT if short else _ADSR_LONG, np.float32)
    params = np.tile(base, (-(-V // len(base)), 1))[:V]
    params = params * rng.uniform(0.9, 1.1, params.shape)
    vel = rng.uniform(0.6, 1.0, V).astype(np.float32)
    kind = {"held_mix": rng.integers(0, 2, V) * 3}.get(name)
    lane = np.arange(V)
    if name == "edge":
        kind = np.where(lane // 8 % 2 == 1, 3, 2)   # 8 decays, 8 sustained
        params[:, 1] = 0.01                     # d_n = 480 >= every rem
    elif name == "one_decay":
        kind = np.where(lane % 32 == 5, 2, 3)
    elif name == "ramp":
        kind = np.array((1, 2, 3, 4))[lane % 4]
    elif name == "decay":
        params[:, 1] = 0.2
    elif name == "release":
        params[:, 3] = 0.5
    p = {k: torch.as_tensor(params[:, i].astype(np.float32), device=device)
         for i, k in enumerate(("attack", "decay", "sustain", "release"))}
    a_n, d_n, r_n, a_c, d_c = _cached_steps(p, 48000.0)
    rows = [a_n.float(), d_n.float(), r_n.float(), a_c, d_c]
    if name == "ramp":
        ramp = np.linspace(0.2, 1.0, B, dtype=np.float32)[:, None]
        sus_p = torch.as_tensor(np.broadcast_to(ramp, (B, V)).copy(),
                                device=device)
    else:
        sus_p = p["sustain"][None].expand(B, V).contiguous()
    vel_t = torch.as_tensor(vel, device=device)
    sus = torch.clamp(sus_p[0] * vel_t, 0.0, 1.0)
    code = {"sustain": 3, "idle": 0, "gate_on": 1, "release_idle": 4,
            "decay": 2, "release": 4}
    if kind is None:
        kind = np.full(V, code[name])
    k = torch.as_tensor(kind.astype(np.float32), device=device)
    zero = torch.zeros(V, device=device)
    rem = torch.where(k == 1, rows[0], torch.where(
        k == 2, rows[1], torch.where(k == 4, rows[2], zero)))
    if name == "edge":
        edge = np.resize(np.array(_ADSR_EDGE_REM, np.float32), V)
        rem = torch.where(k == 2, torch.as_tensor(edge, device=device), rem)
    level = torch.where(k == 1, zero, torch.where(k == 2, 1.0, torch.where(
        k == 0, zero, sus)))
    target = torch.where(k == 1, 1.0, torch.where(k == 4, zero, torch.where(
        k == 0, zero, sus)))
    rinc = torch.where(k == 4, -level / torch.clamp(rem, min=1.0), zero)
    st = torch.stack([k, rem, level, target, sus, vel_t, rinc])
    return st, rows, sus_p


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
