#!/usr/bin/env python3
"""Smoke run of oscen_tpu_torch on one CUDA card.

Usage (from the repository root, on a machine with one NVIDIA H100):

    python3 chip_smoke.py

Phases, one line each, any miss fails the run with a non-zero exit:

1. device   torch/CUDA versions, the card's name and power limit;
2. build    the CUDA kernels from ``oscen_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernels  each kernel against its plain PyTorch version on the card at
            the main path's shapes (V=256, H=32, B=1024 and 4096, with and
            without the fused mix, 3 chained blocks);
4. main     the 256-voice electric piano at 48 kHz through the public API
            (``build_electric_piano(256).compile(..., device="cuda")``, a
            256-note chord, steady blocks, note-offs, ``render_steady``,
            ``steady_checksum``), once per kernel version, with launch
            counts; the first blocks against the same run on the CPU;
5. timing   each kernel's device time (profiler) and its wrapper's and
            plain version's time per call (CUDA events), and a steady
            ``process_block``'s time and device-busy share, after warm-up.

The line before the last is the JSON kernel report, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

SR = 48000.0
VOICES = 256
H = 32
BLOCKS = (1024, 4096)
# y: the bound the JAX package pins for the exact-op-order kernel at its
# ~4-magnitude per-voice harmonic sums; the fused mix sums V voices' errors
Y_TOL = 5e-5
STATE_TOL = 1e-5
MAIN_TOL = 1e-4   # card against CPU, the whole graph


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def check(ok, msg):
    """Fail the run (exit 1, no result line) when ``ok`` is false."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def additive_inputs(V, seed=0):
    """Seeded planes with the step edge cases 0, 64 and 33 in lanes 0-2."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 0.2, (H, V))
    step = rng.integers(0, 65, (V,)).astype(np.float32)
    step[:3] = (0.0, 64.0, 33.0)
    planes = dict(
        osc_re=rng.normal(size=(H, V)), osc_im=rng.normal(size=(H, V)),
        mul_re=np.cos(th), mul_im=np.sin(th),
        cur=rng.uniform(0, 1, (H, V)), tgt=rng.uniform(0, 1, (H, V)),
        mult=rng.uniform(0.9, 1.0, (H, V)))
    planes = {k: np.asarray(v, np.float32) for k, v in planes.items()}
    return planes, step


def chain(fn, planes, step, B, with_mix, blocks=3):
    """Run ``blocks`` chained steady blocks; returns (y, final state)."""
    ore, oim, cur, tgt, s = (planes["osc_re"], planes["osc_im"],
                             planes["cur"], planes["tgt"], step)
    ys = []
    for _ in range(blocks):
        y, ore, oim, cur, tgt, s = fn(
            ore, oim, planes["mul_re"], planes["mul_im"], cur, tgt,
            planes["mult"], s, B, with_mix)
        ys.append(y)
    return ys, (ore, oim, cur, tgt, s)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from oscen_tpu_torch import raw_midi_event
    from oscen_tpu_torch.models.electric_piano import build_electric_piano
    from oscen_tpu_torch.ops.cuda import additive as add
    from oscen_tpu_torch.ops.cuda import build

    # ---- 1. device ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    phase("device", f"python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} "
          f"cards {torch.cuda.device_count()}")
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 2. build ----------------------------------------------------
    t0 = time.perf_counter()
    build.load_library("additive")
    secs, log = build.build_info.get("additive", (0.0, ""))
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    phase("build", f"additive.cu built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {secs:.2f} s); " + " | ".join(regs))

    # ---- 3. kernels against their plain versions ---------------------
    def on_card(a):
        return torch.as_tensor(a, device=dev)

    def kernel_fn(version):
        def fn(ore, oim, mre, mim, cur, tgt, mult, s, B, with_mix):
            return add.additive_voice_block(ore, oim, mre, mim, cur, tgt,
                                            mult, s, B, with_mix=with_mix,
                                            version=version)
        return fn

    def plain_fn(version):
        def fn(ore, oim, mre, mim, cur, tgt, mult, s, B, with_mix):
            if version == "parity":
                return add.plain_parity(ore, oim, mre, mim, cur, tgt, mult,
                                        s, B, with_mix)
            return add.plain_v4(ore, oim, mre, mim, cur, tgt, mult, s, B,
                                add.subgroup_len(B, version), with_mix)
        return fn

    report = {}
    planes_np, step_np = additive_inputs(VOICES)
    planes = {k: on_card(v) for k, v in planes_np.items()}
    step = on_card(step_np)
    for version in add.KERNELS:
        rep = report.setdefault(version, {"max_abs_err": 0.0})
        for B in BLOCKS:
            for with_mix in (False, True):
                before = add.launches[version]
                yk, sk = chain(kernel_fn(version), planes, step, B,
                               with_mix)
                torch.cuda.synchronize()
                check(add.launches[version] == before + 3,
                      f"{version}: launch counter did not advance")
                yp, sp = chain(plain_fn(version), planes, step, B, with_mix)
                y_err = max(float((a - b).abs().max())
                            for a, b in zip(yk, yp))
                s_err = max(float((a - b).abs().max())
                            for a, b in zip(sk, sp))
                y_tol = Y_TOL * (math.sqrt(VOICES) if with_mix else 1.0)
                ok = y_err <= y_tol and s_err <= STATE_TOL
                phase("kernels", f"{version} V={VOICES} B={B} "
                      f"with_mix={with_mix}: y max abs {y_err:.3e} "
                      f"(<= {y_tol:.1e}), state max abs {s_err:.3e} "
                      f"(<= {STATE_TOL:.0e}) {'ok' if ok else 'FAIL'}")
                check(ok, f"{version} disagrees with its plain version")
                rep["max_abs_err"] = max(rep["max_abs_err"], y_err)

    # ---- 4. main path ------------------------------------------------
    def chord(p):
        for i in range(VOICES):
            p.queue_event("midi_in", 0,
                          raw_midi_event([0x90, 36 + (i % 64), 100]))

    def release_half(p):
        # 32 notes x 4 voices each = half the voices
        for i in range(VOICES // 2):
            p.queue_event("midi_in", 300,
                          raw_midi_event([0x80, 36 + (i % 32), 0]))

    def drive(device, B=1024):
        """The main path once; returns (first 4 blocks, all checks)."""
        p = build_electric_piano(VOICES).compile(SR, block_size=B,
                                                 mode="block", device=device)
        chord(p)
        blocks = [p.process_block()["out"]]
        blocks += [p.process_block()["out"] for _ in range(8)]
        release_half(p)
        blocks.append(p.process_block()["out"])
        steady = p.render_steady(16)["out"]
        ck = p.steady_checksum(32)
        return p, blocks, steady, ck

    main_out = {}
    add.reset_launches()
    for version in add.KERNELS:
        os.environ["OSCEN_ADDITIVE_KERNEL"] = version
        t0 = time.perf_counter()
        p, blocks, steady, ck = drive("cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        main_out[version] = (blocks, steady)
        audio = torch.cat(blocks + [steady]).cpu().numpy()
        leaves = []

        def walk(t):
            if isinstance(t, dict):
                for v in t.values():
                    walk(v)
            else:
                leaves.append(t)
        walk(p.state)
        checks = {
            "shape": tuple(blocks[0].shape) == (1024, 2)
            and blocks[0].device.type == "cuda",
            "finite": bool(np.isfinite(audio).all()) and math.isfinite(ck),
            "peak": 0.01 < float(np.abs(audio).max()) < 1000.0,
            "stereo": float(np.abs(audio[:, 0] - audio[:, 1]).max()) > 1e-4,
            "state_on_cuda": all(x.device.type == "cuda" for x in leaves),
        }
        phase("main", f"{version}: 256-voice piano B=1024, 8+16+32 steady "
              f"blocks, checksum {ck:.6e}, peak "
              f"{float(np.abs(audio).max()):.4f}, {secs:.2f} s; checks "
              f"{checks}")
        check(all(checks.values()), f"main path checks failed: {checks}")
    os.environ.pop("OSCEN_ADDITIVE_KERNEL", None)
    launches = dict(add.launches)
    steady_blocks = 8 + 16 + 32
    phase("main", f"kernel launches in the main-path runs: {launches} "
          f"(steady blocks per run: {steady_blocks})")
    for version in add.KERNELS:
        check(launches[version] == steady_blocks,
              f"{version}: {launches[version]} launches, want "
              f"{steady_blocks}")
    v4_all = torch.cat(main_out["v4"][0] + [main_out["v4"][1]])
    par_all = torch.cat(main_out["parity"][0] + [main_out["parity"][1]])
    rel = float(torch.sqrt(torch.mean((v4_all - par_all) ** 2))
                / torch.sqrt(torch.mean(par_all ** 2)))
    phase("main", f"v4 against parity over the run: relative RMS {rel:.3e}")

    # the same sequence on the CPU (plain versions), first 4 blocks
    p = build_electric_piano(VOICES).compile(SR, block_size=1024,
                                             mode="block", device="cpu")
    chord(p)
    cpu_blocks = [p.process_block()["out"] for _ in range(4)]
    for version in add.KERNELS:
        os.environ["OSCEN_ADDITIVE_KERNEL"] = version
        if version == "parity":
            p = build_electric_piano(VOICES).compile(
                SR, block_size=1024, mode="block", device="cpu")
            chord(p)
            cpu_blocks = [p.process_block()["out"] for _ in range(4)]
        errs = [float((a.cpu() - b).abs().max())
                for a, b in zip(main_out[version][0][:4], cpu_blocks)]
        err = max(errs)
        phase("main", f"{version}: card against CPU, first 4 blocks: max "
              f"abs per block {['%.3e' % e for e in errs]} "
              f"(<= {MAIN_TOL:.0e})")
        check(err <= MAIN_TOL, "card and CPU runs disagree")
    os.environ.pop("OSCEN_ADDITIVE_KERNEL", None)

    # ---- 5. timing ---------------------------------------------------
    def time_ms(fn, reps):
        """Wall time per call on the card's clock (CUDA events)."""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def device_ms(fn, reps, kernel=None):
        """Device time per call from the profiler: the named kernel's, or
        the sum over all device activity (the busy time)."""
        from torch.profiler import ProfilerActivity, profile
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and (kernel is None or kernel in e.key):
                total += us
        check(total > 0, "the profiler saw no device time")
        return total / reps / 1e3

    phase("timing", f"card {card}")
    args = [planes[k] for k in ("osc_re", "osc_im", "mul_re", "mul_im",
                                "cur", "tgt", "mult")]
    for version in add.KERNELS:
        for B in BLOCKS:
            kf, pf = kernel_fn(version), plain_fn(version)
            ms = device_ms(lambda: kf(*args, step, B, True), 50,
                           kernel=f"additive_{version}_kernel")
            call_ms = time_ms(lambda: kf(*args, step, B, True), 50)
            plain_ms = time_ms(lambda: pf(*args, step, B, True),
                               3 if version == "parity" else 5)
            phase("timing", f"{version} V={VOICES} B={B} with_mix: kernel "
                  f"{ms * 1e3:.1f} us (device), wrapper call "
                  f"{call_ms * 1e3:.1f} us, plain PyTorch "
                  f"{plain_ms * 1e3:.1f} us/call ({card})")
            if B == 1024:
                report[version].update(ms=ms, plain_ms=plain_ms)
    for B in BLOCKS:
        p = build_electric_piano(VOICES).compile(SR, block_size=B,
                                                 mode="block", device="cuda")
        chord(p)
        p.process_block()
        ms = time_ms(lambda: p.process_block(), 20)
        busy = device_ms(lambda: p.process_block(), 20)
        phase("timing", f"steady process_block V={VOICES} B={B}: "
              f"{ms * 1e3:.1f} us/block, device busy {busy * 1e3:.1f} us "
              f"({100 * busy / ms:.1f}%), real-time factor "
              f"{(B / SR) / (ms * 1e-3):.1f}x ({card})")

    kernels = []
    for version, rep in report.items():
        kernels.append({
            "name": f"additive_voice_{version}", "route": "cuda",
            "source": "oscen_tpu_torch/csrc/additive.cu",
            "replaces": ("oscen_tpu/ops/pallas/additive.py:260"
                         if version == "v4" else
                         "oscen_tpu/ops/pallas/additive.py:401"),
            "launches": launches[version],
            "max_abs_err": rep["max_abs_err"],
            "ms": rep["ms"], "plain_ms": rep["plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
