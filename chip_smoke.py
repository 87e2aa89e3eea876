#!/usr/bin/env python3
"""Smoke run of oscen_tpu_torch on one CUDA card.

Usage (from the repository root, on a machine with one NVIDIA H100):

    python3 chip_smoke.py

Phases, one line each, any miss fails the run with a non-zero exit:

1. device   torch/CUDA versions, the card's name and power limit;
2. build    the CUDA kernels from ``oscen_tpu_torch/csrc`` (one nvcc per
            source, all started together; sm_90a), with register use; from
            the SASS, no local memory (LDL / STL) in any additive kernel
            instance, either ``biquad_kernel`` instance or
            ``fm_operator_kernel``, and the kept work of every ``kabl.cu``
            instance;
3. kernels  each kernel against its plain PyTorch version on the card at
            the main paths' shapes: the additive voice in its four
            versions v4, parity, v3 and v2 (V=256, H=32, B=1024 and 4096
            and a ragged V=3, B=40, 3 chained blocks, with and without the
            fused mix; v3 equal to v4 bit for bit) and v4 with the tremolo
            epilogue (a tremolo state whose tick count crosses K_REBASE in
            the block; equal to v4's mix panned by the plain version, its
            state advance equal to Tremolo.process_block's);
            v4 with and without the mix and with the epilogue at V=1, 3,
            33, 256 and 257 and B=64, 128, 1024 and 4096 against the plain
            version, every time-segment count equal to the one the kernel
            picks; v3, v2, v4 and parity at V=256, B=1024 and 4096 with
            entry steps off the step's cycle (-0.0, 1e-10, -2.5, 65, 2^24,
            stuck counters, +-inf, NaN, ...) in 18 voices: 2 and 4 segments
            equal to one warp per voice with and without the mix, the
            state equal to the plain version's (NaN equal to NaN), y of the
            voices whose plain rows are finite within 5e-5 of the voice's
            largest |y|; phase_scan,
            tpt_svf_scan (row and per-sample coefficients), adsr_scan
            (A -> D -> S, then a gate-off through R -> idle), and the FM
            kernels fract_phase3, fm_chain3_scan and pivot_chain3_scan
            (nonzero feedback, per-sample and block-constant dt) and
            fm_operator_scan (per-sample feedback and level) at V=256,
            B=1024 and 4096 and a ragged V=3, B=37 (the chains also at
            blocks shorter than their skew and around a chunk: V=3, B=1
            and 2, V=33, B=3 and 33, V=256, B=65); 3 chained blocks; the
            chains' zero-feedback branch against their kernels; the
            filter kernels lp18_scan (inputs that saturate its tanh) and
            biquad_scan (an input that decays below 1e-15, so its snaps
            fire) at V=2 and 256, B=1024 and 4096 and V=3, B=37, row and
            per-sample coefficients, 3 chained blocks; the allpass cascade
            allpass_cascade_scan (both halfband branches' betas as lanes)
            at V=1, 2 and 256, B=1024, 2048 and 4096, V=3, B=37 and
            around its skew and a chunk (V=2, B=1, 2 and 33; V=33, B=1 and
            65), 3 chained blocks; tpt_svf_scan and lp18_scan on their staged
            input ring at V=1, 2, 3, 33 and 256 and B=1, 2, 31, 32, 33,
            1024 and 4096, rows and per-sample planes; biquad_scan on its
            ring at V=1, 2, 3, 33 and 256 and B=1, 2, 7, 8, 31, 32, 33, 65
            and 1024 with rows, planes and two mixes (the last block
            decaying below 1e-15), and each of its 32 mixes of row and
            plane coefficients once (one launch each); fm_operator_scan on its ring at V=1,
            3, 33 and 256 and B=1, 2, 31, 32, 33, 65, 1024 and 4096 (one
            launch a block, every output equal); and lp18_scan on
            silence, denormal and 1e20-sized x and signed zeros; lp18_scan's
            tanh over all 2^32 float32 inputs against (float)tanh((double)b)
            and its division over every finite float32 and 70 divisors
            against the true quotient; phase_scan on its ring with the
            short exact wrap at V=1, 2, 3, 33 and 256 and B=1, 31, 33, 1024,
            4096 and 16384, on the main paths' dt and on dt with -0,
            denormals, negatives, values >= 1, +-inf and NaN (bit patterns
            of every output of 3 chained blocks; the plain version over
            all cases' lanes side by side), and its short wrap over all
            2^32 float32 q against q - floor(q); fract_phase3 on lanes on
            its short wrap (p0 and dt in [+0, 1)), off it (edges among
            them) and both in every warp at V=256, B=1024 and 4096, 3
            chained blocks against the plain version on the bit patterns,
            and its short wrap over all 2^32 q against q - trunc(q);
4. main     the models through the public API, each with its launch
            counts set to 0 just before it and read just after:
            - the 256-voice electric piano at 48 kHz
              (``build_electric_piano(256).compile(..., device="cuda")``, a
              256-note chord, steady blocks, note-offs, ``render_steady``,
              ``steady_checksum``; 8 steady blocks under sync debug mode
              "error"), once per kernel version (v4, parity,
              v3, v2) and once with ``OSCEN_EPILOGUE_FUSION=1`` (one
              epilogue launch per steady block, ``explain()`` shows the
              tremolo fused away and advances no counter, the output equal
              to the v4 run's bit for bit);
            - the 256-voice poly synth (``build_poly_synth(256)``, the same
              chord, 8 steady blocks under
              ``torch.cuda.set_sync_debug_mode("error")``, half the notes
              released, ``render_steady``, ``steady_checksum``);
            - the 256-voice fm synth and pivot (``build_fm_synth(256)``,
              ``build_pivot(256)``, the same chord, 8 steady blocks under
              sync debug mode "error"; the pivot then sets op3_feedback to
              0.3 and runs 4 more; half the notes released,
              ``render_steady``, ``steady_checksum``), and the unfused fm
              synth (``fused=False``) for a few blocks, then its steady
              block's wall and device busy time at B=1024 and 4096;
            the first blocks of each against the same run on the CPU; the
            README synth (``build_simple_synth()``) at 440 Hz; the twin
            peaks (``build_twin_peaks()``, fused and ``fused=False``) at
            B=1024 and 4096, seeded noise through ``audio_in`` block by
            block, cutoff_a 640 and resonance 0.8 at block 3, cutoff_b 2500
            at block 5, exactly 1 (fused) or 2 lp18_scan launches per
            block, fused equal to two-node, the card equal to the CPU, and
            how often lp18_scan's tanh took its fallback on that input; and
            a saw -> IirLowpass graph at B=1024 and 33 with a cutoff change
            mid-run, one biquad_scan per block, against the CPU, then its
            steady block's wall and device busy time at B=1024 and 4096;
            the 4x
            saturator (``build_saturator(4)``, the sinc boundary) and the
            same graph with the IIR-halfband boundary (``policy=
            "sinc_iir"``) at B=1024 and 4096, exactly one phase_scan over
            4B samples and 2 allpass_cascade_scan (IIR) per block; the
            simple echo at its defaults (``build_simple_echo()``, 0.25 s,
            a dissolved feedback island) at B=1024 (48 blocks) and 4096
            (12), seeded noise through ``x``, feedback 0.5 from block 0,
            mix 0.8 from the middle, one tpt_svf_scan per block; each
            against the CPU (<= 1e-6), every block after the first under
            sync debug mode "error"; the README synth chained block by
            block into the echo through the tensors it returns on the card
            (no host copy, every block after the first under sync debug
            mode "error", one phase_scan per synth block), equal to the
            same chain fed from numpy; how many phase_scan chunks the short
            wrap re-ran in the poly synth's, the saturators' and the README
            synth's runs (the kernel's device count, read after each);
4b. per_sample  sample mode and the scan islands, each run with its launch
            counts set to 0 just before it and read just after, every block
            after the first under sync debug mode "error": the 256-voice
            piano in sample mode (``mode="sample"``, B=1024, a chord at
            offsets 0, 10 and 100, then 2 steady blocks) against block mode
            with K2 (``OSCEN_ADDITIVE_KERNEL=parity``; its steady blocks from
            the sample-mode state after the chord, RMS <= 4e-5) and K1 (every
            block, RMS <= 1.6e-2) and against the CPU (<= 1e-4), no kernel
            launched in sample mode; the simple echo with no min-delay
            promise (a scan island; 12 blocks of seeded noise, feedback 0.5,
            mix 0.8 from block 3, the first echo back after sample 12001)
            against the dissolved echo on the card and the CPU (<= 1e-6);
            the 4x saturator in sample mode, sinc and IIR-halfband
            boundaries (2 blocks), against block mode (RMS < 1e-3) and the
            CPU (<= 1e-6), with exactly 2 allpass_cascade_scan launches per
            outer sample (sinc_iir); a ``via=24`` Gain island and a Delay
            array (count=2, no promise) at B=256 against the CPU; for the
            piano, the echo and the saturators the device activities of
            their first block (profiler) per sample, the wall of the second
            (CUDA events) and the real-time factor;
4c. assets  the asset slice, each path with its launch counts set to 0
            just before it and read just after: the 256-voice piano's stereo
            output into examples/render_convolution.py's reverb
            (``Convolver(max_ir_len=1 << 16, channels=2)``) through card
            tensors at B=1024 and 4096: the chord, the example's 48000-tap
            IR published (2048 samples to settle), 8 steady blocks, the
            72000-tap IR (the capacity grows to 128 / 32 partitions), 4
            blocks, every block but the first under sync debug mode
            "error" (the growth publish too); exactly one K1 launch per
            steady piano block (held against its plain version on the
            piano's own call), one rFFT and one irFFT per reverb block and
            two irFFTs in a fade (``ops.conv.launches``); the reverb against
            the port on the CPU fed the same dry blocks, against float64
            ``scipy.signal.fftconvolve`` outside the fades, and a ragged
            ``render(..., tail=)`` against the CPU (each <= 1e-5 x the
            peak); the wall (CUDA events), device busy and device
            activities per block (profiler) and real-time factor of piano +
            reverb, the reverb alone and the piano alone, steady, in a fade
            and after the growth; a ``SamplePlayer`` (a 5 s stereo asset at
            44.1 kHz conformed by the native resampler) -> ``TptFilter`` ->
            ``Oscilloscope`` at B=1024, 12 blocks, one K7 launch per block
            (held against its plain version), blocks and ``snapshot``
            against the CPU (<= 1e-6); a checkpoint of the grown reverb
            after a swap restored into a fresh graph on the card, and a
            bundle of a reverb saved mid-fade loaded on the card, the next
            4 blocks ``torch.equal`` to the uninterrupted run; the Convolver
            in sample mode at a 4096-tap capacity, 2 blocks, against block
            mode and the CPU (<= 1e-5 x the peak);
4d. voice_classes the 256-voice piano behind ``VoiceClassHost`` with
            classes (64, 128, 256) at B=1024: 140 notes, steady blocks,
            their release, the 0.2 s tail (an unheld note-off a block, so
            the prepass runs), a down-switch to 64, 40 notes, 60 more (up
            to 128), 60 more (up to 256), 3 steady blocks after each; every
            block after the first, the switches too, under sync debug mode
            "error"; K1 launched at V = 64, 128 and 256 and held against
            its plain version on each class's last call (y <= 5e-5 x
            sqrt(V) with the mix, state torch.equal); the card against the
            port's class host on the CPU (<= 1e-4) and against the
            full-capacity graph on the card (<= 2e-3 x peak / 15.94); K1's
            device time per class and a steady block's wall, busy time and
            device activities per class;
    examples the seven ``oscen_tpu_torch/examples`` through ``main`` for
            0.5 s on the card and on the CPU, at the model's card-vs-CPU
            bound, each kernel of its path launched (K1; K6, K7; K6; K12,
            K13; K15; none for the reverb) and held against its plain
            version on the example's last call;
5. timing   each kernel's device time (profiler; the FM chains with
            block-constant and per-sample dt, the allpass cascade at the
            IIR saturator's V=2 over 2048, 1024, 8192 and 4096 steps, and
            over 2 and 1 (sample mode's lengths);
            biquad_scan also at V=256 with rows and with planes, and it and
            fm_operator_scan also by CUDA events behind a sleep;
            fract_phase3 on the models' lanes, and on lanes off its short
            wrap and on warps of both apart) and its
            plain version's time per call (CUDA events) beside its bound (bytes over
            3.35 TB/s or float ops over 67 TFLOP/s, the larger) and, for a
            one-thread-per-lane scan, its chain floor (B x
            ``tools.CHAIN_OPS`` x 4 cycles at the SM clock nvidia-smi
            reads under load; an additive voice's last time segment, with
            parity's replay of the rotation before it), a steady
            ``process_block``'s time, device-busy share, top device
            activities and real-time factor per model (the piano with v4,
            v3, v2 and the epilogue fusion; for the twin peaks
            a streaming block, staged from the host; the same for the
            saturators and the echo), and host time per node;
6. ablations the tools' ablation kernels (K16: ``kabl_tick`` and
            ``kabl_mma`` of ``csrc/kabl.cu``, ``kabl_hmaj`` of
            ``csrc/kabl_hmaj.cu``; K17: ``fract_abl`` of
            ``csrc/fractabl.cu``): every variant of every
            ``oscen_tpu_torch/tools`` driver at H=32, V=256, B=1024 (K17
            also 4096) against its plain version (state planes and every
            K17 output torch.equal, y within ``kabl.y_bound``), one launch
            counted each, its device time, bound and plain time and its
            delta against K3 and K1 at SUB=32 (or K12); the build phase
            counts the shuffles and mma of every ``kabl.cu`` instance in its
            SASS.  On no model's main path: 0 launches in the kernels JSON.

Each phase line goes to the phase's seconds (the time since the line
before it); a "[total]" line sums them.  The line before the last is the
JSON kernel report (with
``chain_floor_ms``, null where a kernel has no serial chain per lane), the
last line
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
package beside it, the script exits non-zero and prints no result.
``python3 chip_smoke.py per_sample`` runs the per_sample phase alone
(after building the kernels it launches), with no result lines; so do
``assets``, ``voice_classes`` and ``examples``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from contextlib import contextmanager

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
# the poly synth: its kernels equal their plain versions bit for bit, so
# only the float32 glue can differ (peak ~0.1-0.5)
POLY_TOL = 1e-5
SCAN_SHAPES = ((VOICES, 1024), (VOICES, 4096), (3, 37))
# the additive voice: the piano's shapes and a ragged one (B a multiple of 8)
ADD_SHAPES = ((VOICES, 1024), (VOICES, 4096), (3, 40))
# K1's time segments: ragged V around the 2-voice CUDA block and B around
# the 64-tick subgroup (B <= 64: one segment)
SEG_V = (1, 3, 33, VOICES, VOICES + 1)
SEG_B = (64, 128, 1024, 4096)
# entry steps the envelope never produces and the step cycle's edges: a
# fraction off, below 0, above 64, a +1 that rounds to an integer, the
# float below 64, stuck counters (s + 1 == s), inf and NaN; K2-K4 replay
# a segment's start by the cycle's closed form only where the step is an
# integer in 0..64
ODD_STEPS = (0.5, 64.5, 70.0, -3.0, -0.0, 1e-10, -1e-10, -2.5,
             float(np.nextafter(np.float32(64), np.float32(0))), 64.0, 65.0,
             1e-40, 2.0 ** 24, -2.0 ** 25, -1e9, float("nan"), float("inf"),
             float("-inf"))
# K12's lanes: on its short wrap (the models' p0 in [0, 1), dt in (0,
# 0.5)), off it (p0 below 0, or an edge: -0.0, a denormal below 0, 1.0,
# 1 + ulp, 2.5, +-inf, NaN), or both in every warp (even lanes on, odd
# lanes off)
FRACT_LANES = ("on", "off", "mixed")
FRACT_EDGES = (-0.0, -1e-45, 1.0, float(np.nextafter(np.float32(1),
                                                     np.float32(2))),
               2.5, float("inf"), float("-inf"), float("nan"))


def fract_inputs(lanes, V, rng):
    """K12's (p0, dt) [3, V] on the card: ``lanes`` "on", "off" or
    "mixed" (``FRACT_LANES``); the edges sit in lanes 1, 3, .. 15 of op3
    (p0) and op2 (dt)."""
    import torch
    p = rng.uniform(0, 1, (3, V)).astype(np.float32)
    dt = rng.uniform(0.001, 0.5, (3, V)).astype(np.float32)
    off = np.zeros((3, V), bool)
    if lanes == "off":
        off[:] = True
    elif lanes == "mixed":
        off[:, 1::2] = True
    p = np.where(off, -p, p).astype(np.float32)
    if lanes != "on":
        n = len(FRACT_EDGES)
        p[0, 1:2 * n:2] = FRACT_EDGES
        dt[1, 1:2 * n:2] = FRACT_EDGES
    return (torch.as_tensor(p, device="cuda"),
            torch.as_tensor(dt, device="cuda"))


def same_bits(a, b):
    """Every tensor of ``a`` equal to ``b``'s on the int32 bit patterns."""
    import torch
    return all(torch.equal(x.contiguous().view(torch.int32),
                           y.contiguous().view(torch.int32))
               for x, y in zip(a, b))


# the twin peaks runs 2 lanes (fused) or 1; the IIR lowpass graph 1
FILTER_SHAPES = ((2, 1024), (2, 4096), (VOICES, 1024), (VOICES, 4096),
                 (3, 37))
TWIN_TOL = 1e-6   # card against CPU: the kernels equal their plain versions
# the allpass cascade: the IIR saturator runs V=2 lanes (the two branches of
# a halfband stage) over 2B and B samples per block at 4x
ALLPASS_SHAPES = tuple((V, B) for V in (1, 2, VOICES)
                       for B in (1024, 2048, 4096)) + ((3, 37),)
# K10's stages run a sample apart, the FM chains' operators a 32-step chunk
# apart: blocks shorter than the skew and around a chunk
ALLPASS_EDGES = ((2, 1), (2, 2), (2, 33), (33, 1), (33, 65))
CHAIN_EDGES = ((3, 1), (3, 2), (33, 3), (33, 33), (VOICES, 65))
# K7 and K8 read x and their per-sample planes through a ring of 32-step
# chunks (oscen_tpu_torch/csrc/scan_stage.cuh): every B around the chunk
RING_CHUNK = 32   # steps per ring chunk (scan_stage.cuh's kChunk)
RING_B = (1, 2, RING_CHUNK - 1, RING_CHUNK, RING_CHUNK + 1, 1024, 4096)
RING_V = (1, 2, 3, 33, VOICES)
# K9 and K14 on the same ring (K9 also around its 8-step groups); K9 with
# its coefficients as rows, planes and two mixes (bit i: b0, b1, b2, a1,
# a2 a plane; the wrapper expands a mix's rows into planes)
BIQUAD_RING_V = (1, 2, 3, 33, VOICES)
BIQUAD_RING_B = (1, 2, 7, 8, RING_CHUNK - 1, RING_CHUNK, RING_CHUNK + 1, 65,
                 1024)
BIQUAD_FORMS = {"rows": 0b00000, "planes": 0b11111, "mixed": 0b10110,
                "mixed2": 0b01001}
OPERATOR_RING_V = (1, 3, 33, VOICES)
OPERATOR_RING_B = (1, 2, RING_CHUNK - 1, RING_CHUNK, RING_CHUNK + 1, 65,
                   1024, 4096)
# K6 on the same ring: the saturator's 4x lane reaches 16384 steps
PHASE_RING_V = (1, 2, 3, 33, VOICES)
PHASE_RING_B = (1, 31, 33, 1024, 4096, 16384)
# the least time the card could take (NVIDIA H100 SXM data sheet): the
# bytes a call must move over the memory rate, or its float ops over the
# float32 rate outside the tensor cores, whichever is larger
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float ops per sample step and lane, counted from each kernel's loop in
# oscen_tpu_torch/csrc (compares and selects not counted, a transcendental
# counts 1); the additive kernels' lanes are (harmonic, voice) pairs
OPS_PER_STEP = {"v4": 21, "parity": 16, "v3": 23, "v2": 20,
                # v4's lanes, plus the pan once per sample (PAN_OPS)
                "v4_epilogue": 21,
                "phase_scan": 3, "tpt_svf_scan": 12,
                "adsr_scan": 26, "fract_phase3": 9, "fm_chain3_scan": 59,
                "pivot_chain3_scan": 59, "fm_operator_scan": 20,
                "lp18_scan": 13, "biquad_scan": 9,
                # 3 per stage (a subtract, a product, a sum), S = 2 stages
                "allpass_cascade_scan": 6}


# the tremolo pan per mix sample: the tick, the phase and its wrap (5), the
# sine (1), the pan (2) and the two channels (3)
PAN_OPS = 11


def bound_of(key, inputs, outputs, steps, lanes, extra_ops=0):
    """``bound_ms`` and ``bound_by`` of one call: every input tensor read
    once and every output written once, against the ops it computes."""
    tensors = [t for t in list(inputs) + list(outputs)
               if hasattr(t, "element_size")]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (OPS_PER_STEP[key] * steps * lanes + extra_ops) / F32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# seconds per phase: the time since the previous phase line goes to the
# phase of the line that reports the work
PHASE_SECONDS = {}
T_START = time.perf_counter()
_LAST_LINE = [T_START]


def phase(name, msg):
    now = time.perf_counter()
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + now - _LAST_LINE[0]
    _LAST_LINE[0] = now
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
    step[:min(V, 3)] = (0.0, 64.0, 33.0)[:min(V, 3)]
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

# the ablation kernels (K16, K17): the kernels JSON's name, source and the
# TPU kernels they replace; on no model's main path
ABLATION_KERNELS = {
    "kabl_tick": ("kabl_tick", "kabl.cu",
                  "tools/kabl.py:129; tools/kabl2.py:185; tools/kabl3.py:152;"
                  " tools/kabl4.py:193; tools/kabl5.py:239; "
                  "tools/kabl6.py:157"),
    "kabl_mma": ("kabl_mma", "kabl.cu",
                 "tools/kabl2.py:185; tools/kabl3.py:152"),
    "kabl_hmaj": ("kabl_hmaj", "kabl_hmaj.cu", "tools/kabl5.py:254"),
    "fract_abl": ("fract_abl", "fractabl.cu",
                  "tools/fractabl.py:67; tools/fractabl2.py:81; "
                  "tools/fractabl2.py:135"),
}
# float ops per tick and (harmonic, voice) lane of each ablation body,
# counted from the loops of csrc/kabl.cu as for K3 (23: the row chain 6,
# amp 4, rotation 5, product 1, the running power 6, the harmonic sum 1);
# the h-major body per tick, harmonic and voice (im 3, amp 4, accumulate
# 2); bf16 ops counted as float ops, tensor-core products not counted
OPS_PER_STEP.update({f"kabl:{k}": v for k, v in {
    "full": 23, "no_amp": 19, "no_rows": 19, "no_env": 18, "no_reduce": 22,
    "base": 19, "recur": 23, "loads": 17, "sub64": 23, "bf16_vpu": 23,
    "const_rows": 17, "noim": 12, "noout": 23, "defmix": 23, "defmix64": 23,
    "scan": 18, "scan64": 18, "dot32": 19, "dot4": 19, "onehot_sub": 18,
    "onehot_all": 17, "bf16_mxu": 22, "hmaj_cp": 9, "hmaj_x": 9,
    "hmaj_t2": 9, "k3": 23, "k1": 21}.items()})


def sass_checks(build, tools):
    """From the SASS of the built libraries: the additive kernels keep
    their harmonic samples in registers (no LDL or STL in any
    ``additive_closed_kernel`` or ``additive_parity_kernel`` instance; the
    epilogue's instances, ``<SUB, 4, true>``, keep the local array of the
    float64 sine's slow path for huge arguments, which the tremolo's phase
    in [0, 2 pi) never takes, and are counted apart), and
    every kernel instance of csrc/kabl.cu keeps its work: the variants
    whose results nothing reads, noout its 32 shuffles (as full), dot32 one
    mma per k-tile (5) and dot4 four whole-block dots (20); and no LDL or
    STL in either ``biquad_kernel`` instance (rows, planes) or in
    ``fm_operator_kernel``."""
    import re

    def built(name):
        # this tree's build (a build of another tree may sit beside it)
        lib = build.BUILD_DIR / f"lib{name}-{build.source_digest(name)}.so"
        check(lib.exists(), f"{name}.cu SASS: no library to count it in")
        return str(lib)
    try:
        add_c = tools.sass_counts(built("additive"), ("LDL", "STL"))
        kabl_c = tools.sass_counts(built("kabl"), ("SHFL", "HMMA"))
        scan_c = {**tools.sass_counts(built("iir"), ("LDL", "STL")),
                  **tools.sass_counts(built("fm"), ("LDL", "STL"))}
    except (RuntimeError, subprocess.SubprocessError) as e:
        check(False, f"SASS: {e}")
    # K9's two instances (rows, planes) and K14 keep their staged inputs in
    # registers
    for kern, want in (("biquad_kernel", 2), ("fm_operator_kernel", 1)):
        rows = [c for fn, c in scan_c.items() if kern in fn]
        local = sum(c["LDL"] + c["STL"] for c in rows)
        instr = sorted(c["instr"] for c in rows)
        phase("build", f"{kern} SASS: {len(rows)} instances, LDL + STL "
              f"{local}, {instr[0] if instr else 0}-"
              f"{instr[-1] if instr else 0} instructions")
        check(len(rows) == want and local == 0,
              f"{kern} SASS: {len(rows)} instances (want {want}), {local} "
              f"local-memory instructions (want 0)")
    parts, local, epi = [], 0, 0
    for fn, c in add_c.items():
        m = re.search(r"(additive_(?:closed|parity)_kernel)I((?:L[ib]\d+E)+)E",
                      fn)
        if m:
            args = re.findall(r"L[ib](\d+)E", m.group(2))
            parts.append(f"{m.group(1)}<{','.join(args)}> {c['instr']} "
                         f"instr, LDL {c['LDL']}, STL {c['STL']}")
            if len(args) == 3 and args[2] == "1":
                epi += 1
            else:
                local += c["LDL"] + c["STL"]
    phase("build", "additive.cu SASS: " + "; ".join(parts))
    check(len(parts) == 19 and epi == 4 and local == 0,
          f"additive.cu SASS: {local} local-memory instructions in the "
          f"{len(parts) - epi} instances without the epilogue (want 0, and "
          f"15 such instances and 4 with it)")
    parts, by_inst = [], {}
    for fn, c in kabl_c.items():
        m = re.search(r"(kabl_(?:tick|mma)_kernel)I((?:Li\d+E)+)E", fn)
        if m:
            args = ",".join(re.findall(r"Li(\d+)E", m.group(2)))
            by_inst[f"{m.group(1)}<{args}>"] = (c["SHFL"], c["HMMA"])
            parts.append(f"{m.group(1)}<{args}> {c['instr']} instr, SHFL "
                         f"{c['SHFL']}, HMMA {c['HMMA']}")
    phase("build", "kabl.cu SASS (SUB, ROWS, AMP, IM, RED, OUT, PREC): "
          + "; ".join(parts))
    full = by_inst.get("kabl_tick_kernel<32,0,0,0,0,0,0>", (0, 0))
    noout = by_inst.get("kabl_tick_kernel<32,0,0,0,0,1,0>", (-1, 0))
    dot32 = by_inst.get("kabl_mma_kernel<32,7,0,0,0,0,0>", (0, 0))
    dot4 = by_inst.get("kabl_mma_kernel<32,8,0,0,0,0,0>", (0, 0))
    check(full[0] > 0 and noout[0] == full[0] and dot32[1] >= 5
          and dot4[1] >= 20,
          f"kabl.cu SASS: the discarded work was deleted (noout SHFL "
          f"{noout[0]}, full {full[0]}; dot32 HMMA {dot32[1]} < 5 or dot4 "
          f"HMMA {dot4[1]} < 20)")


def ablations(torch, dev, card, report, device_ms, time_ms):
    """K16 and K17 on the card: every variant of every ablation tool at
    its full width (H=32, V=256, B=1024; K17 also B=4096), its kernel
    against its plain version (state planes and every K17 output
    torch.equal, y within ``kabl.y_bound``), its device time, bound and
    plain time, and the deltas against K3 and K1 at SUB=32 (kabl6's v3b
    and v4) or against K12.  Fills the report's kabl_tick, kabl_mma,
    kabl_hmaj and fract_abl entries."""
    import importlib

    from oscen_tpu_torch.ops.cuda import additive as add
    from oscen_tpu_torch.ops.cuda import fm as kfm
    from oscen_tpu_torch.ops.cuda import fractabl as kfa
    from oscen_tpu_torch.ops.cuda import kabl as kab
    B = 1024
    timed = {}    # body -> (device ms, plain ms, bound), timed once
    errs = {k: 0.0 for k in ABLATION_KERNELS}
    rows = []
    t0 = time.perf_counter()
    for tool, variants in kab.TOOLS.items():
        mod = importlib.import_module(f"oscen_tpu_torch.tools.{tool}")
        x = {k: torch.as_tensor(v, device=dev)
             for k, v in mod.inputs(B).items()}
        xc = x   # the check's inputs
        if "tbl" in x:
            # the tool's table is zeros, which it times; the check takes a
            # seeded random one, so that the one-hot rows are not 0
            x["tbl"] = x["tbl"].to(torch.bfloat16)
            tbl = np.random.default_rng(B).uniform(0, 0.5, x["tbl"].shape)
            xc = dict(x, tbl=torch.as_tensor(tbl.astype(np.float32),
                                             device=dev).to(torch.bfloat16))
        for v, run in variants.items():
            body = run.body
            prod = body in ("k3", "k1")
            kern = "additive_closed" if prod else kab.kernel_of(body)
            counters = add.launches if prod else kab.launches
            before = sum(counters.values())
            out = kab.run_variant(tool, v, xc, B)
            torch.cuda.synchronize()
            check(sum(counters.values()) == before + 1,
                  f"{tool} {v}: launch counter did not advance")
            plain = kab.run_variant(tool, v, xc, B, plain=True)
            err = float((out[0] - plain[0]).abs().max())
            bound = kab.y_bound(tool, v, plain[0], VOICES)
            same = all(torch.equal(a, b) for a, b in zip(out[1:], plain[1:]))
            check(err <= bound and same,
                  f"{tool} {v}: kernel and plain version disagree (y "
                  f"{err:.3e} > {bound:.3e} or state planes differ)")
            if kern in errs:
                errs[kern] = max(errs[kern], err)
            if body not in timed:
                ms = device_ms(lambda: kab.run_variant(tool, v, x, B), 20,
                               kernel=kern + "_kernel")
                plain_ms = time_ms(
                    lambda: kab.run_variant(tool, v, x, B, plain=True), 1,
                    warm=0)
                ins = [t for k, t in x.items() if k in kab.HMAJ_PLANES
                       + kab.PLANES + ("step",)
                       or (k == "tbl" and body in kab.VARIANTS
                           and kab.VARIANTS[body].rows in kab.ONEHOT_ROWS)
                       or (k in ("r1", "r2") and body == "hmaj_x")]
                timed[body] = (ms, plain_ms, bound_of(
                    f"kabl:{body}", ins, out, B, H * VOICES))
            rows.append((tool, v, body, kern, err, bound))
    k3, k1 = timed["k3"][0], timed["k1"][0]
    for tool, v, body, kern, err, bound in rows:
        ms, plain_ms, b = timed[body]
        phase("ablations", f"{tool} {v} ({kern} {body}): kernel "
              f"{ms * 1e3:.2f} us (device), bound {b['bound_ms'] * 1e3:.3f} "
              f"us ({b['bound_by']}), plain {plain_ms * 1e3:.1f} us/call; "
              f"delta against K3 at SUB=32 {(ms - k3) * 1e3:+.2f} us, "
              f"against K1 {(ms - k1) * 1e3:+.2f} us; y max abs {err:.3e} "
              f"(<= {bound:.3e}), state planes equal ok ({card})")
    for key, body in (("kabl_tick", "full"), ("kabl_mma", "onehot_all"),
                      ("kabl_hmaj", "hmaj_cp")):
        ms, plain_ms, b = timed[body]
        report[key] = dict(max_abs_err=errs[key], ms=ms, plain_ms=plain_ms,
                           **b)

    # K17: every layout against K12, B=1024 and 4096
    rng = np.random.default_rng(17)
    for B in (1024, 4096):
        p = torch.as_tensor(rng.uniform(0, 1, (3, VOICES)).astype(np.float32),
                            device=dev)
        dt = torch.as_tensor(np.full((3, VOICES), 440.0 / SR, np.float32),
                             device=dev)
        k12 = kfm.fract_phase3(p, dt, B)
        k12_ms = device_ms(lambda: kfm.fract_phase3(p, dt, B), 20,
                           kernel="fract_phase3_kernel")
        for layout in kfa.LAYOUTS:
            before = kfa.launches[kfa.KERNEL]
            got = kfa.fract_layout(layout, p, dt, B)
            torch.cuda.synchronize()
            raw, c = kfa.PLAIN[layout](p, dt, B)
            same = all(torch.equal(a, b) for a, b in zip(got, k12)) and all(
                torch.equal(a, b) for a, b in zip(
                    got, (*kfa.planes(layout, raw), c)))
            check(same and kfa.launches[kfa.KERNEL] == before + 1,
                  f"fract_abl {layout} B={B}: not equal to K12 and the "
                  f"plain version, or the launch was not counted")
            ms = device_ms(lambda: kfa.fract_layout_raw(layout, p, dt, B),
                           20, kernel="fract_abl_kernel")
            plain_ms = time_ms(lambda: kfa.PLAIN[layout](p, dt, B), 1,
                               warm=0)
            b = bound_of("fract_phase3", (p, dt),
                         kfa.fract_layout_raw(layout, p, dt, B), B, VOICES)
            phase("ablations", f"fract_abl {layout} V={VOICES} B={B}: "
                  f"equal to K12 and to the plain version (torch.equal, "
                  f"every output) ok; kernel {ms * 1e3:.2f} us (device), "
                  f"K12 {k12_ms * 1e3:.2f} us, delta "
                  f"{(ms - k12_ms) * 1e3:+.2f} us, bound {b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}),"
                  f" plain {plain_ms * 1e3:.1f} us/call ({card})")
            if B == 1024 and layout == "direct":
                report["fract_abl"] = dict(max_abs_err=0.0, ms=ms,
                                           plain_ms=plain_ms, **b)
    phase("ablations", f"{len(rows)} K16 variants and "
          f"{2 * len(kfa.LAYOUTS)} K17 cases in "
          f"{time.perf_counter() - t0:.1f} s")


def ring_checks(torch, dev, kiir):
    """K7 and K8 on their staged input ring, and K8's two short paths:
    tpt_svf_scan and lp18_scan against their plain versions (torch.equal,
    every output of 3 chained blocks) at every B around the ring's 32-step
    chunk and ragged V, rows and per-sample planes (the LP18 with g and h
    over the twin peaks' ranges and x that saturates its tanh); the LP18 on
    silence, denormal and 1e20-sized x and signed zeros; its tanh over all
    2^32 float32 inputs against (float)tanh((double)b); its division over
    every finite float32 and 70 divisors against the true quotient.  Any
    mismatch fails the run."""
    def on_card(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def twin_g(rng, shape):
        return np.tan(np.pi * rng.uniform(0.001, 0.33, shape))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    t0 = time.perf_counter()
    cases = 0
    for V in RING_V:
        for B in RING_B:
            for per_sample in (False, True):
                rng = np.random.default_rng(V * 41 + B + per_sample)
                shape = (B, V) if per_sample else (V,)
                zt = [on_card(rng.standard_normal(V)) for _ in range(2)]
                z8 = on_card(rng.uniform(-0.8, 0.8, (3, V)))
                for _ in range(3):
                    x = on_card(rng.standard_normal((B, V)))
                    h, g, k = (on_card(rng.uniform(0.3, 0.9, shape)),
                               on_card(rng.uniform(0.05, 0.5, shape)),
                               on_card(rng.uniform(1.0, 2.0, shape)))
                    out = kiir.tpt_svf_scan(x, h, g, k, *zt)
                    x8 = on_card(3.0 * rng.standard_normal((B, V)))
                    g8 = on_card(twin_g(rng, shape))
                    h8 = on_card(rng.uniform(0.0, 1.98, shape))
                    out8 = kiir.lp18_scan(x8, g8, h8, z8)
                    torch.cuda.synchronize()
                    check(same(out, kiir.plain_tpt_svf_scan(x, h, g, k, *zt)),
                          f"tpt_svf_scan V={V} B={B} per_sample={per_sample}:"
                          f" kernel and plain version differ")
                    check(same(out8, kiir.plain_lp18_scan(x8, g8, h8, z8)),
                          f"lp18_scan V={V} B={B} per_sample={per_sample}: "
                          f"kernel and plain version differ")
                    zt, z8 = list(out[1:]), out8[1]
                cases += 2
    phase("kernels", f"tpt_svf_scan and lp18_scan on the ring: V in {RING_V}"
          f", B in {RING_B}, rows and per-sample planes, 3 chained blocks "
          f"each: {cases} cases equal to the plain versions (torch.equal) "
          f"ok ({time.perf_counter() - t0:.1f} s)")
    # the LP18's edge inputs: the division's zero and guard paths
    for per_sample in (False, True):
        V, B = 4, 1024
        rng = np.random.default_rng(11 + per_sample)
        shape = (B, V) if per_sample else (V,)
        z = torch.zeros(3, V, device=dev)
        blocks = [np.zeros((B, V)), 1e-40 * rng.standard_normal((B, V)),
                  np.where(rng.uniform(size=(B, V)) < 0.01, 1e20, 0.0)
                  * np.sign(rng.standard_normal((B, V))),
                  np.full((B, V), -0.0), 0.5 * rng.standard_normal((B, V))]
        for xb in blocks:
            x = on_card(xb)
            g = on_card(twin_g(rng, shape))
            h = on_card(rng.uniform(0.0, 1.98, shape))
            out = kiir.lp18_scan(x, g, h, z)
            torch.cuda.synchronize()
            plain = kiir.plain_lp18_scan(x, g, h, z)
            check(same(out, plain) and all(
                torch.equal(torch.signbit(a), torch.signbit(b))
                for a, b in zip(out, plain)),
                f"lp18_scan edge inputs (per_sample={per_sample}): kernel "
                f"and plain version differ")
            z = out[1]
    phase("kernels", "lp18_scan on silence, denormal x, |x| = 1e20 and "
          "signed zeros, rows and per-sample planes: equal to the plain "
          "version, signs of zeros included, ok")
    t0 = time.perf_counter()
    wrong, undecided, first = kiir.tanh_exact_sweep()
    secs = time.perf_counter() - t0
    nans = 2 * (2 ** 23 - 1)
    phase("kernels", f"lp18_scan's tanh over all 2^32 float32 inputs: "
          f"{wrong} differ from (float)tanh((double)b); the rounding test "
          f"left {undecided} undecided ({nans} NaN patterns, "
          f"{(undecided - nans) / (2 ** 32 - nans):.2e} of the rest) "
          f"({secs:.2f} s)")
    check(wrong == 0, f"lp18_scan's tanh differs from the float64 tanh "
          f"(first at the bit pattern {first})")
    fc = np.array([0.001, 0.33, 700 / SR, 1000 / SR, 2100 / SR])
    d = np.concatenate([
        1.0 + np.tan(np.pi * fc).astype(np.float32),
        [1.0, 2.0, 4.0, np.nextafter(np.float32(2), np.float32(0)),
         np.nextafter(np.float32(4), np.float32(0)),
         np.nextafter(np.float32(1), np.float32(2))],
        np.random.default_rng(5).uniform(1.0, 4.0, 59)]).astype(np.float32)
    t0 = time.perf_counter()
    wrong = kiir.div_sweep(on_card(d))
    phase("kernels", f"lp18_scan's division over every finite float32 and "
          f"{len(d)} divisors in [1, 4] (the twin peaks' 1 + g among "
          f"them): {wrong} pairs differ from a / d "
          f"({time.perf_counter() - t0:.2f} s)")
    check(wrong == 0, "lp18_scan's division differs from the true quotient")


def k9_k14_ring_checks(torch, dev, kiir, kfm):
    """K9 and K14 on their staged input ring: biquad_scan against its plain
    version (torch.equal, every output of 3 chained blocks, the input
    decaying below 1e-15 in the last one, so the snaps fire) at every B
    around the ring's 32-step chunk and 8-step groups and ragged V, with
    row, plane and mixed coefficients, one launch per block; every one of
    its 32 mixes of rows and planes once at V=3, B=40 (one launch each);
    fm_operator_scan likewise (3 chained blocks) at every B up to
    4096 and ragged V.  Any mismatch fails the run."""
    def on_card(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def biquad_operands(rng, V, B, mask):
        # each lane's JUCE lowpass (q = 1/sqrt(2)) as rows; a plane moves
        # each sample's coefficient by up to 1e-3 of itself
        n = 1.0 / np.tan(np.pi * rng.uniform(1500.0, 8000.0, V) / SR)
        c1 = 1.0 / (1.0 + math.sqrt(2.0) * n + n * n)
        rows = (c1, 2 * c1, c1, 2 * c1 * (1 - n * n),
                c1 * (1 - math.sqrt(2.0) * n + n * n))
        return [on_card(r * (1 + 1e-3 * rng.uniform(-1, 1, (B, V)))
                        if mask >> i & 1 else r) for i, r in enumerate(rows)]

    t0 = time.perf_counter()
    cases = 0
    for V in BIQUAD_RING_V:
        for B in BIQUAD_RING_B:
            for form, mask in BIQUAD_FORMS.items():
                rng = np.random.default_rng(V * 41 + B + mask)
                v = [on_card(rng.standard_normal(V)) for _ in range(2)]
                before = kiir.launches["biquad_scan"]
                for i in range(3):
                    coefs = biquad_operands(rng, V, B, mask)
                    x = rng.standard_normal((B, V))
                    if i == 2:
                        x *= np.exp(-np.arange(B) / 4.0)[:, None]
                    x = on_card(x)
                    out = kiir.biquad_scan(x, *coefs, *v)
                    torch.cuda.synchronize()
                    check(same(out, kiir.plain_biquad_scan(x, *coefs, *v)),
                          f"biquad_scan V={V} B={B} {form}: kernel and "
                          f"plain version differ")
                    v = list(out[1:])
                check(kiir.launches["biquad_scan"] == before + 3,
                      f"biquad_scan V={V} B={B} {form}: not one launch a "
                      f"block")
                cases += 1
    for mask in range(32):
        rng = np.random.default_rng(mask)
        coefs = biquad_operands(rng, 3, 40, mask)
        x = on_card(rng.standard_normal((40, 3)))
        v = [on_card(rng.standard_normal(3)) for _ in range(2)]
        before = kiir.launches["biquad_scan"]
        out = kiir.biquad_scan(x, *coefs, *v)
        torch.cuda.synchronize()
        check(kiir.launches["biquad_scan"] == before + 1
              and same(out, kiir.plain_biquad_scan(x, *coefs, *v)),
              f"biquad_scan mix {mask:05b}: no launch, or kernel and plain "
              f"version differ")
    phase("kernels", f"biquad_scan on the ring: V in {BIQUAD_RING_V}, B in "
          f"{BIQUAD_RING_B}, coefficients {list(BIQUAD_FORMS)}, 3 chained "
          f"blocks (the last decaying) each: {cases} cases, and all 32 mixes"
          f" of rows and planes, equal to the plain version (torch.equal), "
          f"one launch a block, ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    cases = 0
    for V in OPERATOR_RING_V:
        for B in OPERATOR_RING_B:
            rng = np.random.default_rng(V * 43 + B)
            carry = (on_card(rng.uniform(0, 1, V)),
                     on_card(rng.normal(size=V)))
            before = kfm.launches["fm_operator_scan"]
            for _ in range(3):
                planes = [on_card(rng.uniform(lo, hi, (B, V))) for lo, hi in (
                    (0.002, 0.03), (-0.2, 0.2), (0.0, 0.6), (0.1, 1.0),
                    (0.3, 1.0))]
                out = kfm.fm_operator_scan(*carry, *planes)
                torch.cuda.synchronize()
                check(same(out, kfm.plain_fm_operator_scan(*carry, *planes)),
                      f"fm_operator_scan V={V} B={B}: kernel and plain "
                      f"version differ")
                carry = out[1:]
            check(kfm.launches["fm_operator_scan"] == before + 3,
                  f"fm_operator_scan V={V} B={B}: not one launch a block")
            cases += 1
    phase("kernels", f"fm_operator_scan on the ring: V in {OPERATOR_RING_V}"
          f", B in {OPERATOR_RING_B}, 3 chained blocks each: {cases} cases "
          f"equal to the plain version (torch.equal), one launch a block, ok "
          f"({time.perf_counter() - t0:.1f} s)")


def phase_checks(torch, dev, kphase):
    """K6 on its staged ring with the short exact wrap: phase_scan against
    its plain version (torch.equal on the int32 patterns of every output
    of 3 chained blocks, so signs of zeros and NaN payloads count) at V in
    PHASE_RING_V and B in PHASE_RING_B, on the main paths' dt and on dt
    with -0, denormals, negatives, values >= 1, +-inf and NaN (which
    re-run their chunks with floor); the wrap over all 2^32 float32 q
    against q - floor(q).  The plain version runs once per B and block
    over every case's lanes side by side (its lanes are independent).
    Any mismatch fails the run."""
    def bits(t):
        return t.contiguous().view(torch.int32)

    f32 = np.float32
    edges = np.array([-0.0, 0.0, 1e-40, -1e-40, np.nextafter(f32(1), f32(0)),
                      1.0, np.nextafter(f32(1), f32(2)), 1.5, 2.0, 2.5,
                      -0.25, -1.0, -3.5, 7.0, np.inf, -np.inf, np.nan],
                     np.float32)
    t0 = time.perf_counter()
    reruns = {False: 0, True: 0}
    kphase.take_reruns(dev)
    for B in PHASE_RING_B:
        cases = [(V, edge) for V in PHASE_RING_V for edge in (False, True)]
        rngs, ps = {}, {}
        for V, edge in cases:
            rngs[V, edge] = rng = np.random.default_rng(V * 43 + B + edge)
            p0 = rng.uniform(0, 1, V).astype(np.float32)
            if edge:
                p0[0] = -0.0
            ps[V, edge] = torch.as_tensor(p0, device=dev)
        for _ in range(3):
            dts, outs = [], []
            for V, edge in cases:
                rng = rngs[V, edge]
                dt = rng.uniform(0.0, 0.5, (B, V)).astype(np.float32)
                if edge:
                    idx = rng.integers(0, B * V, min(B * V, 64))
                    dt.reshape(-1)[idx] = rng.choice(edges, len(idx))
                dt = torch.as_tensor(dt, device=dev)
                before = kphase.launches["phase_scan"]
                out = kphase.phase_scan(ps[V, edge], dt)
                torch.cuda.synchronize()
                check(kphase.launches["phase_scan"] == before + 1,
                      "phase_scan: launch counter did not advance")
                reruns[edge] += kphase.take_reruns(dev)
                dts.append(dt)
                outs.append(out)
            plain = kphase.plain_phase_scan(
                torch.cat([ps[c] for c in cases]), torch.cat(dts, dim=1))
            lo = 0
            for (V, edge), out in zip(cases, outs):
                check(torch.equal(bits(out[0]), bits(plain[0][:, lo:lo + V]))
                      and torch.equal(bits(out[1]), bits(plain[1][lo:lo + V])),
                      f"phase_scan V={V} B={B} edges={edge}: kernel and "
                      f"plain version differ")
                ps[V, edge] = out[1]
                lo += V
    n_cases = len(PHASE_RING_B) * len(PHASE_RING_V) * 2
    phase("kernels", f"phase_scan on the ring: V in {PHASE_RING_V}, B in "
          f"{PHASE_RING_B}, the main paths' dt and dt with -0, denormals, "
          f"negatives, >= 1, +-inf and NaN, 3 chained blocks each: "
          f"{n_cases} cases equal to the plain version (bit patterns) ok; "
          f"chunks re-run with floor: {reruns[False]} on the main paths' "
          f"dt, {reruns[True]} on the edge dt "
          f"({time.perf_counter() - t0:.1f} s)")
    check(reruns[False] == 0 and reruns[True] > 0,
          "phase_scan: the short wrap re-ran a chunk of in-range dt, or "
          "none of the edge dt")
    t0 = time.perf_counter()
    wrong, taken = kphase.wrap_sweep()
    phase("kernels", f"phase_scan's short wrap over all 2^32 float32 q: "
          f"{wrong} differ from q - floor(q) (bit patterns); the short path "
          f"takes {taken} (2^30 = {2 ** 30}) "
          f"({time.perf_counter() - t0:.2f} s)")
    check(wrong == 0 and taken == 2 ** 30,
          "phase_scan's short wrap differs from q - floor(q)")


def tanh_fallback_share(torch, kiir, x, g, h, z):
    """How often one lp18_scan call's tanh was left undecided by its
    rounding test: the plain loop's bp1 values through ``kiir.tanh_exact``
    on the card.  Returns (undecided samples, samples, chunks with an
    undecided sample, chunks, the short path equal to the float64 tanh):
    the kernel re-runs a whole chunk of RING_CHUNK steps for any
    undecided sample in it."""
    rows = [(c, c.dim() == 1) for c in (g, h)]
    z0, z1, z2 = z[0], z[1], z[2]
    bps = []
    for t in range(x.shape[0]):
        gt, ht = [c if row else c[t] for c, row in rows]
        hp = (x[t] - ht * z0 - z1 - z2) / (1.0 + gt)
        bp1 = gt * hp + z0
        bps.append(bp1)
        z0 = torch.tanh(bp1.double()).float()
        bp2 = gt * bp1 + z1
        z1, z2 = bp2, gt * bp2 + z2
    b = torch.stack(bps)
    y, undecided = kiir.tanh_exact(b.reshape(-1).contiguous())
    chunks = list(torch.split(b, RING_CHUNK))
    redone = sum(kiir.tanh_exact(c.reshape(-1).contiguous())[1] > 0
                 for c in chunks)
    return undecided, b.numel(), redone, len(chunks), bool(torch.equal(
        y, torch.tanh(b.reshape(-1).double()).float()))


# ---- helpers shared by the phases ------------------------------------
def reset_all():
    """Every launch count to 0, and phase_scan's re-run count."""
    from oscen_tpu_torch.ops.cuda import adsr, additive, fm, iir, phase
    for mod in (additive, fm, phase, iir, adsr):
        mod.reset_launches()
    phase.take_reruns()


def piano_env(run):
    """The additive kernel version (or the fused epilogue) a piano built
    next runs."""
    from oscen_tpu_torch.ops.cuda import additive
    os.environ["OSCEN_ADDITIVE_KERNEL"] = (
        "v4" if run == additive.EPILOGUE else run)
    os.environ["OSCEN_EPILOGUE_FUSION"] = (
        "1" if run == additive.EPILOGUE else "0")


@contextmanager
def no_sync(on):
    """Any wait for the card inside raises (sync debug mode)."""
    import torch
    if on:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        if on:
            torch.cuda.set_sync_debug_mode("default")


def sat_graph(policy):
    """The oversampled saturator: a 2 kHz saw and a hard clip at 4x, the
    sinc boundary (``build_saturator``) or another policy's."""
    from oscen_tpu_torch import Graph, HardClip, PolyBlepOscillator
    from oscen_tpu_torch.models.simple import build_saturator
    if policy == "sinc":
        return build_saturator(4)
    g = Graph("Sat4iir")
    g.output("audio_out", "stream")
    osc = g.add("osc", PolyBlepOscillator.saw(2000.0, 0.6), rate=4)
    clip = g.add("clip", HardClip(), rate=4)
    g.connect(osc.output, clip.input)
    g.connect(clip.output, "audio_out", policy=policy)
    return g


def echo_input(B, n):
    """The echo's seeded noise, ``n`` blocks of ``B``."""
    return (np.random.default_rng(5).standard_normal(n * B) * 0.3
            ).astype(np.float32)


PER_SAMPLE_B = 1024
PIANO_OFFSETS = (0, 10, 100)   # the chord's note-ons, a third at each
# sample mode at 256 voices against block mode: K2 (parity, its steady
# blocks from the same state) at the JAX package's 5e-6 at 4 voices x
# sqrt(256 / 4); K1 (v4, every block) at its 2e-3 x 8; against the CPU the
# piano's card-vs-CPU bound (PERF.md section 2)
PIANO_K2_RMS = 4e-5
PIANO_K1_RMS = 1.6e-2
SAT_MODES_RMS = 1e-3   # tests/test_multirate.py:196-203


def per_sample_phase(card):
    """Phase ``per_sample``: the 256-voice piano in sample mode, the
    reference echo's scan island (no promise), the 4x saturator in sample
    mode (sinc and IIR-halfband boundaries) and two small islands, each
    against its block-mode or dissolved counterpart and the CPU, every
    block after the first under sync debug mode "error"; the wall per
    block, device activities per sample and real-time factor of the
    first three.  Returns K10's launches on the sample-mode path."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from oscen_tpu_torch import Delay, Gain, Graph, raw_midi_event
    from oscen_tpu_torch.graph.node import tree_map
    from oscen_tpu_torch.models.electric_piano import build_electric_piano
    from oscen_tpu_torch.models.simple import build_simple_echo
    from oscen_tpu_torch.ops.cuda import additive as add
    from oscen_tpu_torch.ops.cuda import iir as kiir
    from oscen_tpu_torch.ops.cuda import phase as kphase
    B = PER_SAMPLE_B
    cuda_kind = torch.autograd.DeviceType.CUDA

    def device_activities(prof):
        """The device activities a profiler run recorded, counted on its
        raw events (a block here holds ~10^5 of them; building the
        profiler's event tree for them takes tens of seconds)."""
        return sum(1 for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda_kind)

    def run_blocks(step, n, device, stats):
        """``step(i)`` for blocks 0..n-1, each after the first under sync
        debug mode "error" on the card.  With ``stats`` (a dict), block 0
        runs under the profiler, which counts its device activities
        (kernels, copies, fills), and block 1 is timed by CUDA events."""
        ys = []
        for i in range(n):
            on_card = device == "cuda" and i > 0
            if stats is not None and i == 0:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    ys.append(step(i))
                    torch.cuda.synchronize()
                stats["activities"] = device_activities(prof)
            elif stats is not None and i == 1:
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                with no_sync(on_card):
                    ys.append(step(i))
                b.record()
                torch.cuda.synchronize()
                stats["wall_ms"] = a.elapsed_time(b)
            else:
                with no_sync(on_card):
                    ys.append(step(i))
        return ys

    def report_stats(label, stats):
        per = stats["activities"] / B
        rtf = (B / SR) / (stats["wall_ms"] * 1e-3)
        phase("per_sample", f"{label}: wall {stats['wall_ms']:.1f} ms per "
              f"B={B} block (CUDA events), {stats['activities']} device "
              f"activities in one block ({per:.1f} per sample, profiler), "
              f"real-time factor {rtf:.4f}x ({card})")
        return per

    def max_abs(a, b):
        return float((a.cpu() - b.cpu()).abs().max())

    def rms(a, b):
        return float(torch.sqrt(torch.mean((a.cpu() - b.cpu()) ** 2)))

    def on_cuda(c):
        """Every state leaf of ``c`` on the card."""
        leaves = []

        def w(t):
            if isinstance(t, dict):
                for v in t.values():
                    w(v)
            elif isinstance(t, (tuple, list)):
                for v in t:
                    w(v)
            else:
                leaves.append(t)
        w(c.state)
        return bool(leaves) and all(x.device.type == "cuda" for x in leaves)

    # -- the piano, 256 voices, sample mode ------------------------------
    def piano(device, mode, version="v4", stats=None, snap=None,
              start=None):
        """A chord at PIANO_OFFSETS, then 2 steady blocks.  ``snap``: keep
        the state after the chord block there; ``start``: a state to run
        the steady blocks from instead of this graph's own (the chord
        block's host-side work, the voice allocation, is this graph's)."""
        piano_env(version)
        p = build_electric_piano(VOICES).compile(SR, block_size=B, mode=mode,
                                                 device=device)

        def step(i):
            if i == 0:
                for v in range(VOICES):
                    p.queue_event("midi_in", PIANO_OFFSETS[v % 3],
                                  raw_midi_event([0x90, 36 + v % 64, 100]))
            if i == 1 and snap is not None:
                snap["state"] = tree_map(lambda t: t.clone(), p.state)
            if i == 1 and start is not None:
                p.state = tree_map(lambda t: t.clone(), start)
            return p.process_block()["out"]
        return p, run_blocks(step, 3, device, stats)

    reset_all()
    stats, snap = {}, {}
    t0 = time.perf_counter()
    p, ys = piano("cuda", "sample", stats=stats, snap=snap)
    secs = time.perf_counter() - t0
    y_sample = torch.cat(ys)
    sample_launched = {k: v for k, v in add.launches.items() if v} | {
        k: v for k, v in kiir.launches.items() if v} | {
        k: v for k, v in kphase.launches.items() if v}
    piano_per = report_stats("piano 256 voices, sample mode", stats)
    ref, ref_launches = {}, {}
    for version in ("parity", "v4"):
        for synced in (True, False):
            reset_all()
            _, yb = piano("cuda", "block", version,
                          start=snap["state"] if synced else None)
            ref[(version, synced)] = yb
            ref_launches[(version, synced)] = add.launches[version]
    _, y_cpu = piano("cpu", "sample")
    y_cpu = torch.cat(y_cpu)
    steady = torch.cat(ys[1:])
    # the kernels' anchor: the steady blocks from the sample-mode state
    # after the chord block, so K2 and K1 are held to the ticks alone
    readings = {
        "K2 (parity) steady blocks from the same state, RMS":
        (rms(steady, torch.cat(ref[("parity", True)][1:])), PIANO_K2_RMS),
        "K1 (v4) all 3 blocks, RMS":
        (rms(y_sample, torch.cat(ref[("v4", False)])), PIANO_K1_RMS),
        "CPU sample mode max abs": (max_abs(y_sample, y_cpu), MAIN_TOL)}
    info = {
        "K1 steady from the same state": rms(
            steady, torch.cat(ref[("v4", True)][1:])),
        "K2 all 3 blocks": rms(y_sample, torch.cat(ref[("parity", False)])),
        "K2 steady blocks": rms(steady,
                                torch.cat(ref[("parity", False)][1:])),
        "the chord block (composed closed forms)": rms(
            ys[0], ref[("parity", False)][0])}
    peak = float(y_sample.abs().max())
    checks = {"shape": tuple(y_sample.shape) == (3 * B, 2),
              "finite": bool(torch.isfinite(y_sample).all()),
              "peak": 0.01 < peak < 1000.0,
              "state_on_cuda": on_cuda(p),
              "no kernel in sample mode": not sample_launched,
              "K2 and K1 launches (2 steady blocks each)": all(
                  n == 2 for n in ref_launches.values()),
              **{k: v <= lim for k, (v, lim) in readings.items()}}
    phase("per_sample", f"piano 256 voices sample mode B={B}: a chord at "
          f"offsets {PIANO_OFFSETS} then 2 steady blocks (blocks 2-3 under "
          f"sync debug mode 'error'), peak {peak:.4f}, {secs:.1f} s; "
          + "; ".join(f"{k} {v:.3e} (<= {lim:.1e})"
                      for k, (v, lim) in readings.items())
          + "; RMS, for the record: "
          + "; ".join(f"{k} {v:.3e}" for k, v in info.items())
          + f"; checks {checks}")
    check(all(checks.values()), f"per_sample piano checks failed: {checks}")
    piano_env("v4")

    # -- the reference echo without its promise: a scan island ----------
    # (12 blocks, 12288 samples: the first echo returns at sample 12001)
    n_echo = 12

    def echo(device, min_delay, stats=None):
        x = echo_input(B, n_echo)
        c = build_simple_echo(min_delay=min_delay).compile(
            SR, block_size=B, device=device)
        c.set_value("feedback", 0.5)

        def step(i):
            if i == 3:
                c.set_value("mix", 0.8)
            return c.process_block(
                stream_inputs={"x": x[i * B:(i + 1) * B]})["out"]
        return c, torch.cat(run_blocks(step, n_echo, device, stats)), x

    reset_all()
    stats = {}
    t0 = time.perf_counter()
    c, y_isl, x = echo("cuda", False, stats)
    secs = time.perf_counter() - t0
    island_launches = {k: v for k, v in kiir.launches.items() if v}
    echo_per = report_stats("simple echo scan island", stats)
    _, y_dis, _ = echo("cuda", True)
    _, y_isl_cpu, _ = echo("cpu", False)
    keep = np.where(np.arange(n_echo * B) < 3 * B,
                    np.float32(1.0) - np.float32(0.5),
                    np.float32(1.0) - np.float32(0.8)).astype(np.float32)
    wet = np.abs(y_isl.cpu().numpy() - x * keep)
    D = 12000 + 1          # read 12000 samples back, before the push
    readings = {"dissolved island (card) max abs": (max_abs(y_isl, y_dis),
                                                    TWIN_TOL),
                "CPU island max abs": (max_abs(y_isl, y_isl_cpu),
                                       TWIN_TOL)}
    paths = {e["node"]: e["path"] for e in c.explain() if "path" in e}
    checks = {"finite": bool(np.isfinite(wet).all()),
              "dry_only_before_the_delay": float(wet[:D].max()) == 0.0,
              "echo_returns": float(wet[D:].max()) > 0.05,
              "scan_island": paths.get("delay") == paths.get("filter")
              == "scan_island",
              "state_on_cuda": on_cuda(c),
              "no kernel in the island": not island_launches,
              **{k: v <= lim for k, (v, lim) in readings.items()}}
    phase("per_sample", f"simple echo, no promise (0.25 s, a scan island) "
          f"B={B}: {n_echo} blocks of seeded noise (all but the first under "
          f"sync debug mode 'error'), feedback 0.5, mix 0.8 from block 3, "
          f"wet peak after sample {D} {float(wet[D:].max()):.4f}, "
          f"{secs:.1f} s; "
          + "; ".join(f"{k} {v:.3e} (<= {lim:.0e})"
                      for k, (v, lim) in readings.items())
          + f"; checks {checks}")
    check(all(checks.values()), f"per_sample echo checks failed: {checks}")

    # -- the 4x saturator in sample mode ---------------------------------
    k10 = 0
    sat_per = {}
    for policy in ("sinc", "sinc_iir"):
        def sat(device, mode, stats=None, policy=policy):
            c = sat_graph(policy).compile(SR, block_size=B, mode=mode,
                                          device=device)
            return torch.cat(run_blocks(
                lambda i: c.process_block()["audio_out"], 2, device, stats))
        reset_all()
        stats = {}
        t0 = time.perf_counter()
        y_s = sat("cuda", "sample", stats)
        secs = time.perf_counter() - t0
        got = kiir.launches["allpass_cascade_scan"]
        others = {k: v for k, v in {**kphase.launches,
                                    **add.launches}.items() if v}
        # one down resampler run per outer sample: one launch per halfband
        # stage (2 at 4x), over 2 and 1 samples
        want = 2 * 2 * B if policy == "sinc_iir" else 0
        k10 += got
        sat_per[policy] = report_stats(
            f"saturator 4x {policy}, sample mode", stats)
        y_b = sat("cuda", "block")
        y_cpu = sat("cpu", "sample")
        readings = {"block mode RMS": (rms(y_s, y_b), SAT_MODES_RMS),
                    "CPU sample mode max abs": (max_abs(y_s, y_cpu),
                                                TWIN_TOL)}
        peak = float(y_s.abs().max())
        checks = {"finite": bool(torch.isfinite(y_s).all()),
                  "peak": 0.5 < peak < 1.2,
                  "allpass_cascade_scan launches": got == want,
                  "no other kernel": not others,
                  **{k: v <= lim for k, (v, lim) in readings.items()}}
        phase("per_sample", f"saturator 4x {policy} sample mode B={B}: 2 "
              f"blocks (the second under sync debug mode 'error'), peak "
              f"{peak:.4f}, {secs:.1f} s, allpass_cascade_scan launches "
              f"{got} (want {want}: 2 per outer sample), "
              + "; ".join(f"{k} {v:.3e} (<= {lim:.0e})"
                          for k, (v, lim) in readings.items())
              + f"; checks {checks}")
        check(all(checks.values()),
              f"per_sample saturator {policy} checks failed: {checks}")

    # -- small islands: a via=24 cycle and a Delay array ------------------
    def via_island():
        g = Graph("FB")
        g.input("x", "stream")
        g.output("out", "stream")
        mix = g.add("mix", Gain(1.0))
        fb = g.add("fb", Gain(0.6))
        g.connect("x", mix.input)
        g.connect(mix.output, fb.input)
        g.connect(fb.output, mix.input, via=24)
        g.connect(mix.output, "out")
        return g

    def delay_array():
        g = Graph("DA")
        g.input("x", "stream")
        g.output("out", "stream")
        d = g.add("d", Delay(37.5, 0.5), count=2)
        g.connect("x", d.input)
        g.connect(d.output, "out")
        return g
    small_B = 256
    for label, build in (("via=24 Gain island", via_island),
                         ("Delay array count=2, no promise", delay_array)):
        x = echo_input(small_B, 4)

        def small(device, build=build, x=x):
            c = build().compile(SR, block_size=small_B, device=device)
            return torch.cat(run_blocks(
                lambda i: c.process_block(stream_inputs={
                    "x": x[i * small_B:(i + 1) * small_B]})["out"],
                4, device, None))
        y_c, y_h = small("cuda"), small("cpu")
        err = max_abs(y_c, y_h)
        phase("per_sample", f"{label} B={small_B}: 4 blocks (2-4 under "
              f"sync debug mode 'error'), peak {float(y_c.abs().max()):.4f},"
              f" card against CPU max abs {err:.3e} (<= {TWIN_TOL:.0e})")
        check(err <= TWIN_TOL and float(y_c.abs().max()) > 0.1,
              f"per_sample {label}: card and CPU disagree")
    phase("per_sample", f"device activities per sample: piano "
          f"{piano_per:.1f}, echo island {echo_per:.1f}, saturator sinc "
          f"{sat_per['sinc']:.1f}, sinc_iir {sat_per['sinc_iir']:.1f}; "
          f"K10 launches on the sample-mode path {k10} ({card})")
    return {"allpass_cascade_scan": k10}


ASSET_BLOCKS = (1024, 4096)
REVERB_CAP = 1 << 16          # examples/render_convolution.py's capacity
IR2_TAPS = 72000              # 1.5 s: above the capacity, so it grows
REVERB_STEADY = 8             # steady blocks after the first fade
REVERB_AFTER = 4              # blocks from the growth swap on
REVERB_TOL = 1e-5             # x the output's peak: card vs CPU, vs float64
SAMPLER_TOL = 1e-6            # K7 equals its plain version
SAMPLER_BLOCKS = 12


def reverb_ir(seed, n):
    """examples/render_convolution.py's IR: seeded noise decaying with
    tau = 0.15 s, x 0.05."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32)
            * np.exp(-np.arange(n, dtype=np.float32) / (SR * 0.15))
            * 0.05)


def assets_phase(card):
    """Phase ``assets``: the 256-voice piano into a stereo convolution
    reverb (examples/render_convolution.py's graph) through card tensors,
    a sampler into a filter and a scope, a checkpoint and a bundle of the
    reverb on the card, and the Convolver in sample mode; each against
    the port on the CPU, the reverb also against float64 ``fftconvolve``.
    Returns the phase's K1 and K7 launches."""
    import torch
    from scipy.signal import fftconvolve
    from torch.profiler import ProfilerActivity, profile
    from oscen_tpu_torch import (AudioAsset, Convolver, Graph, Oscilloscope,
                                 SamplePlayer, TptFilter, raw_midi_event)
    from oscen_tpu_torch.models.electric_piano import build_electric_piano
    from oscen_tpu_torch.ops import conv as tconv
    from oscen_tpu_torch.ops.cuda import additive as add
    from oscen_tpu_torch.ops.cuda import iir as kiir
    from oscen_tpu_torch.nodes import filters as nfilters
    from oscen_tpu_torch.utils import native
    from oscen_tpu_torch.utils.bundle import load_bundle, save_bundle
    from oscen_tpu_torch.utils.checkpoint import load_state, save_state
    import tempfile
    piano_env("v4")
    scratch = tempfile.mkdtemp(prefix="oscen_assets_")
    ir1, ir2 = reverb_ir(0, int(SR)), reverb_ir(1, IR2_TAPS)
    fade_len = int(0.02 * SR)
    phase_launches = {"additive_voice_v4": 0, "tpt_svf_scan": 0}

    def reverb(B, device, cap=REVERB_CAP, mode="block"):
        g = Graph("ConvolutionReverb")
        g.input("x", "stream", channels=2)
        g.output("out", "stream", channels=2)
        g.external("ir")
        cv = g.add("conv", Convolver(max_ir_len=cap, channels=2))
        g.connect("ir", cv.ir)
        g.connect("x", cv.input)
        g.connect(cv.output, "out")
        return g.compile(SR, block_size=B, mode=mode, device=device)

    def capture(mod, name, seen):
        """``mod.name`` wrapped to keep its last call's arguments."""
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            seen[name] = (a, kw)
            return fn(*a, **kw)
        setattr(mod, name, wrapped)
        return fn

    def block_stats(step, prep=None, reps=6):
        """Median wall per block (CUDA events, the odd reps) and device busy
        and activities per block (profiler, the even reps); ``prep`` runs
        before each rep, outside both."""
        walls, busy, acts, n = [], 0.0, 0, 0
        for i in range(reps):
            if prep is not None:
                prep()
            torch.cuda.synchronize()
            if i % 2 == 0:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    step()
                    torch.cuda.synchronize()
                for e in prof.key_averages():
                    if e.device_type == torch.autograd.DeviceType.CUDA:
                        busy += getattr(e, "self_device_time_total",
                                        getattr(e, "self_cuda_time_total",
                                                0.0))
                        acts += e.count
                n += 1
            else:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                step()
                b.record()
                torch.cuda.synchronize()
                walls.append(a.elapsed_time(b))
        return float(np.median(walls)), busy / n / 1e3, acts / n

    def report(label, B, st):
        wall, busy, acts = st
        phase("assets", f"{label} B={B}: wall {wall * 1e3:.1f} us per block "
              f"(CUDA events), device busy {busy * 1e3:.1f} us "
              f"({100 * busy / wall:.1f}%), {acts:.0f} device activities "
              f"per block, real-time factor "
              f"{(B / SR) / (wall * 1e-3):.1f}x ({card})")

    # ---- 1. the piano into the reverb --------------------------------
    kept_reverb = {}
    for B in ASSET_BLOCKS:
        n_fade = -(-2048 // B)                  # 2048 samples to settle
        n_first = n_fade + REVERB_STEADY
        reset_all()
        tconv.reset_launches()
        t0 = time.perf_counter()
        p = build_electric_piano(VOICES).compile(SR, block_size=B,
                                                 mode="block", device="cuda")
        rv = reverb(B, "cuda")
        for i in range(VOICES):
            p.queue_event("midi_in", 0,
                          raw_midi_event([0x90, 36 + (i % 64), 100]))
        rv.publish_asset("ir", AudioAsset.from_samples(ir1, int(SR)))
        dry, wet, ffts, seen = [], [], [], {}
        n_blocks = n_first + REVERB_AFTER
        for i in range(n_blocks):
            if i == n_first:
                with no_sync(True):   # the growth swap: 64 -> 128 (16 -> 32)
                    rv.publish_asset("ir", AudioAsset.from_samples(
                        ir2, int(SR)))
            if i == n_first - 1:
                fn1 = capture(add, "additive_voice_block", seen)
            with no_sync(i > 0):
                tconv.reset_launches()
                x = p.process_block()["out"]
                y = rv.process_block(stream_inputs={"x": x})["out"]
            if i == n_first - 1:
                add.additive_voice_block = fn1
            ffts.append(dict(tconv.launches))
            dry.append(x)
            wet.append(y)
        k1 = add.launches["v4"]
        phase_launches["additive_voice_v4"] += k1
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        # K1 against its plain version on the call the piano made
        a, kw = seen["additive_voice_block"]
        outs_k = fn1(*a, **kw)
        outs_p = add.plain_block(*a[:9], kw.get("with_mix", False), "v4")
        k1_err = float((outs_k[0] - outs_p[0]).abs().max())
        k1_state = all(torch.equal(u, v) for u, v in
                       zip(outs_k[1:], outs_p[1:]))
        # the reverb on the CPU, fed the same dry blocks
        rc = reverb(B, "cpu")
        rc.publish_asset("ir", AudioAsset.from_samples(ir1, int(SR)))
        wet_cpu = []
        for i in range(n_blocks):
            if i == n_first:
                rc.publish_asset("ir", AudioAsset.from_samples(ir2,
                                                               int(SR)))
            wet_cpu.append(rc.process_block(stream_inputs={
                "x": dry[i].cpu().numpy()})["out"])
        y_card = torch.cat(wet).cpu().numpy()
        y_cpu = torch.cat(wet_cpu).numpy()
        x64 = torch.cat(dry).cpu().numpy().astype(np.float64)
        peak = float(np.abs(y_card).max())
        t_swap = n_first * B
        ref1 = np.stack([fftconvolve(x64[:, c], ir1.astype(np.float64))
                         [:len(x64)] for c in range(2)], -1)
        ref2 = np.stack([fftconvolve(x64[:, c], ir2.astype(np.float64))
                         [:len(x64)] for c in range(2)], -1)
        err_cpu = float(np.abs(y_card - y_cpu).max())
        err_ref = max(
            float(np.abs(y_card[fade_len:t_swap]
                         - ref1[fade_len:t_swap]).max()),
            float(np.abs(y_card[t_swap + fade_len:]
                         - ref2[t_swap + fade_len:]).max()))
        fading = {"rfft": 1, "irfft": 2}
        steady = {"rfft": 1, "irfft": 1}
        want_ffts = [fading if (i * B < fade_len or t_swap <= i * B
                                < t_swap + fade_len) else steady
                     for i in range(n_blocks)]
        # the ragged last block of an offline render: a tail after the
        # last dry block, on the card and the CPU
        tail_in = dry[-1][:B // 2 + 100]
        r_card = rv.render(B // 2 + 100, stream_inputs={"x": tail_in},
                           tail=B // 3)["out"]
        r_cpu = rc.render(B // 2 + 100, stream_inputs={
            "x": tail_in.cpu().numpy()}, tail=B // 3)["out"]
        err_tail = float(np.abs(r_card - r_cpu).max())
        P = tuple(rv.state["conv"]["fdl"].shape)
        checks = {
            "shape": tuple(y_card.shape) == (n_blocks * B, 2),
            "finite": bool(np.isfinite(y_card).all()),
            "peak": 0.01 < peak < 1000.0,
            "grown": P == (131072 // B, B + 1, 2),
            # the chord's block runs the event path's closed forms
            "K1 one launch per steady piano block": k1 == n_blocks - 1,
            "K1 y vs plain": k1_err <= Y_TOL * math.sqrt(VOICES),
            "K1 state vs plain (torch.equal)": k1_state,
            "FFTs per block": ffts == want_ffts,
            "card vs CPU": err_cpu <= REVERB_TOL * peak,
            "vs float64 fftconvolve": err_ref <= REVERB_TOL * peak,
            "ragged tail vs CPU": err_tail <= REVERB_TOL * peak,
        }
        phase("assets", f"piano 256 voices -> reverb B={B}: the chord, IR "
              f"48000 taps published ({n_fade} fade blocks), "
              f"{REVERB_STEADY} steady blocks, the 72000-tap IR (capacity "
              f"grown to fdl {P}), {REVERB_AFTER} blocks; all but the first "
              f"under sync debug mode 'error'; peak {peak:.4f}, {secs:.1f} "
              f"s; card vs CPU {err_cpu:.3e}, vs float64 fftconvolve "
              f"outside the fades {err_ref:.3e}, ragged tail vs CPU "
              f"{err_tail:.3e} (each <= {REVERB_TOL:.0e} x peak); K1 "
              f"launches {k1} (want {n_blocks - 1}: every block but the "
              f"chord's), K1 y vs plain "
              f"{k1_err:.3e}; FFTs per block {ffts}; checks {checks}")
        check(all(checks.values()), f"assets reverb B={B}: {checks}")
        kept_reverb[B] = (p, rv, dry)

    # ---- timing: piano + reverb, the reverb alone; steady, in a fade,
    # after the growth -------------------------------------------------
    for B in ASSET_BLOCKS:
        p, rv, dry = kept_reverb[B]
        xb = dry[-1]

        def both():
            return rv.process_block(stream_inputs={
                "x": p.process_block()["out"]})

        def alone():
            return rv.process_block(stream_inputs={"x": xb})

        def swap():
            rv.publish_asset("ir", AudioAsset.from_samples(ir2, int(SR)))
        report("piano + reverb, after the growth", B, block_stats(both))
        report("reverb alone, after the growth", B, block_stats(alone))
        report("piano + reverb, in a fade (P=" + str(131072 // B) + ")", B,
               block_stats(both, prep=swap))
        report("reverb alone, in a fade", B, block_stats(alone, prep=swap))
        q = build_electric_piano(VOICES).compile(SR, block_size=B,
                                                 mode="block", device="cuda")
        for i in range(VOICES):
            q.queue_event("midi_in", 0,
                          raw_midi_event([0x90, 36 + (i % 64), 100]))
        r64 = reverb(B, "cuda")
        r64.publish_asset("ir", AudioAsset.from_samples(ir1, int(SR)))
        for _ in range(-(-2048 // B)):
            r64.process_block(stream_inputs={"x": q.process_block()["out"]})
        report(f"piano + reverb, steady (P={REVERB_CAP // B})", B,
               block_stats(lambda: r64.process_block(stream_inputs={
                   "x": q.process_block()["out"]})))
        report("reverb alone, steady", B, block_stats(
            lambda: r64.process_block(stream_inputs={"x": xb})))
        report("piano alone, steady", B, block_stats(q.process_block))
        del q, r64

    # ---- 2. a sampler, a filter and a scope --------------------------
    check(native.available(), "the native host library did not build")
    t = np.arange(5 * 44100) / 44100.0
    rng = np.random.default_rng(2)
    stereo = np.stack([
        0.5 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * rng.standard_normal(
            len(t)),
        0.5 * np.sin(2 * np.pi * 330.0 * t) + 0.1 * rng.standard_normal(
            len(t))]).astype(np.float32)
    asset = AudioAsset.from_samples(stereo, 44100)

    def sampler(device, B=1024):
        g = Graph("Sampler")
        g.input("cutoff", "value", default=1500.0)
        g.output("out", "stream")
        g.external("sample")
        sp = g.add("sp", SamplePlayer())
        f = g.add("f", TptFilter(1500.0, 0.707))
        sc = g.add("scope", Oscilloscope())
        g.connect("sample", sp.buf)
        g.connect("cutoff", f.cutoff)
        g.connect(sp.output, f.input)
        g.connect(f.output, sc.input)
        g.connect(sc.output, "out")
        c = g.compile(SR, block_size=B, device=device)
        c.publish_asset("sample", asset)
        ys = []
        for i in range(SAMPLER_BLOCKS):
            if i == 4:
                c.set_value("cutoff", 800.0)
            with no_sync(device == "cuda" and i > 0):
                ys.append(c.process_block()["out"])
        return c, torch.cat(ys).cpu(), Oscilloscope.snapshot(
            c.node_state("scope"))

    reset_all()
    seen = {}
    fn7 = capture(nfilters, "tpt_svf_scan", seen)
    try:
        c_card, y_card, snap_card = sampler("cuda")
    finally:
        nfilters.tpt_svf_scan = fn7
    k7 = kiir.launches["tpt_svf_scan"]
    phase_launches["tpt_svf_scan"] += k7
    a, kw = seen["tpt_svf_scan"]
    k7_same = all(torch.equal(u, v) for u, v in zip(
        fn7(*a, **kw), kiir.plain_tpt_svf_scan(*a, **kw)))
    _, y_cpu, snap_cpu = sampler("cpu")
    err = float((y_card - y_cpu).abs().max())
    conformed = int(c_card.node_state("sp")["length"])
    checks = {"native resampler": native.available(),
              "conformed to 48 kHz": conformed == 240000,
              "finite": bool(torch.isfinite(y_card).all()),
              "peak": 0.05 < float(y_card.abs().max()) < 2.0,
              "K7 one launch per block": k7 == SAMPLER_BLOCKS,
              "K7 vs plain (torch.equal)": k7_same,
              "card vs CPU": err <= SAMPLER_TOL,
              "snapshot vs CPU": snap_card.shape == snap_cpu.shape
              and float(np.abs(snap_card - snap_cpu).max()) <= SAMPLER_TOL}
    phase("assets", f"sampler -> TptFilter -> scope B=1024: a 5 s stereo "
          f"asset at 44.1 kHz conformed to {conformed} frames at 48 kHz "
          f"(native resampler), {SAMPLER_BLOCKS} blocks (all but the first "
          f"under sync debug mode 'error'), cutoff 800 Hz from block 4, "
          f"card vs CPU {err:.3e} (<= {SAMPLER_TOL:.0e}), snapshot of "
          f"{len(snap_card)} samples, tpt_svf_scan launches {k7} (want "
          f"{SAMPLER_BLOCKS}); checks {checks}")
    check(all(checks.values()), f"assets sampler: {checks}")
    report("sampler -> filter -> scope, steady", 1024,
           block_stats(c_card.process_block))

    # ---- 3. checkpoint and bundle on the card ------------------------
    B = 1024
    p, rv, dry = kept_reverb[B]
    x_next = [p.process_block()["out"] for _ in range(4)]
    # the grown reverb, saved right after a swap (mid-fade), restored into
    # a fresh graph at the grown capacity
    rv.publish_asset("ir", AudioAsset.from_samples(ir1, int(SR)))
    ck = f"{scratch}/reverb.pkl"
    save_state(rv, ck)
    fresh = reverb(B, "cuda", cap=1 << 17)
    load_state(fresh, ck)
    mirrors = [dict(fresh._mirrors["conv"])]
    # a reverb at the grown capacity through a bundle: publish, a block,
    # the swap to the 1.5 s IR, saved mid-fade
    rb = reverb(B, "cuda", cap=1 << 17)
    rb.publish_asset("ir", AudioAsset.from_samples(ir1, int(SR)))
    for x in dry[:3]:
        rb.process_block(stream_inputs={"x": x})
    rb.publish_asset("ir", AudioAsset.from_samples(ir2, int(SR)))
    save_bundle(rb, f"{scratch}/bundle")
    loaded = load_bundle(f"{scratch}/bundle")
    mirrors.append(dict(loaded._mirrors["conv"]))
    runs = {}
    for name, g in (("uninterrupted", rv), ("restored", fresh),
                    ("bundle uninterrupted", rb), ("bundle loaded", loaded)):
        with no_sync(True):
            runs[name] = torch.cat([g.process_block(stream_inputs={"x": x})
                                    ["out"] for x in x_next])
    same_ck = torch.equal(runs["uninterrupted"], runs["restored"])
    same_b = torch.equal(runs["bundle uninterrupted"], runs["bundle loaded"])
    phase("assets", f"checkpoint of the grown reverb B={B} after a swap "
          f"(mid-fade), restored into a fresh graph on the card: next 4 "
          f"blocks equal (torch.equal) {same_ck}; bundle of a reverb saved "
          f"mid-fade, load_bundle on the card: next 4 blocks equal "
          f"{same_b}; restored fade mirrors {mirrors} (want fade_pos 0)")
    check(same_ck and same_b and loaded.device.type == "cuda"
          and mirrors == [{"fade_pos": 0}] * 2,
          "assets: checkpoint or bundle resume differs")

    # ---- 4. the Convolver in sample mode (depth cut: 2 blocks) -------
    ir_s = reverb_ir(3, 3000)
    x_s = torch.cat(dry).cpu().numpy()[:2 * B]
    outs = {}
    for label, device, mode in (("sample, card", "cuda", "sample"),
                                ("block, card", "cuda", "block"),
                                ("sample, CPU", "cpu", "sample")):
        c = reverb(B, device, cap=4096, mode=mode)
        c.publish_asset("ir", AudioAsset.from_samples(ir_s, int(SR)))
        t0 = time.perf_counter()
        ys = []
        for i in range(2):
            xi = x_s[i * B:(i + 1) * B]
            xi = torch.as_tensor(xi, device=device)
            with no_sync(device == "cuda" and i > 0):
                ys.append(c.process_block(stream_inputs={"x": xi})["out"])
        outs[label] = torch.cat(ys).cpu()
        if label == "sample, card":
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    peak = float(outs["sample, card"].abs().max())
    e_block = float((outs["sample, card"] - outs["block, card"]).abs().max())
    e_cpu = float((outs["sample, card"] - outs["sample, CPU"]).abs().max())
    ok = (e_block <= REVERB_TOL * peak and e_cpu <= REVERB_TOL * peak
          and peak > 0.01)
    phase("assets", f"Convolver sample mode, capacity 4096, B={B}, 2 blocks "
          f"(a 3000-tap IR faded in; the second under sync debug mode "
          f"'error'), {secs:.1f} s: against block mode {e_block:.3e}, "
          f"against the CPU {e_cpu:.3e} (<= {REVERB_TOL:.0e} x peak "
          f"{peak:.4f}) {'ok' if ok else 'FAIL'}")
    check(ok, "assets: Convolver sample mode disagrees")
    phase("assets", f"K1 and K7 launches on the phase's paths: "
          f"{phase_launches} ({card})")
    return phase_launches


VC_CAPS = (64, 128, 256)   # the capacity classes of the 256-voice piano
VC_B = 1024
VC_TAIL = 0.2              # s after a release before a voice may be dropped
VC_STEADY = 3              # steady blocks in each class
# card against the full-capacity graph: tests/test_voice_classes.py's 2e-3
# at the peak it measured, 15.94, scaled to this schedule's peak
VC_FULL_TOL = 2e-3 / 15.94
VC_MHZ = 1980.0            # the H100's top SM clock, for the chain floors


def capture_calls(targets):
    """Wrap each ``(module, name)`` of ``targets`` to keep its last call's
    arguments by key; returns (seen, the wrapped functions by key, a
    function that puts them back)."""
    seen, originals = {}, {}
    for key, (mod, name) in targets.items():
        fn = getattr(mod, name)
        originals[key] = (mod, name, fn)

        def wrapped(*a, _fn=fn, _key=key, **kw):
            seen.setdefault(_key, []).append((a, kw))
            return _fn(*a, **kw)
        setattr(mod, name, wrapped)

    def restore():
        for mod, name, fn in originals.values():
            setattr(mod, name, fn)
    return seen, {k: v[2] for k, v in originals.items()}, restore


def k1_vs_plain(fn, a, kw):
    """(max |y| error, states equal, max |y|) of K1 against its plain
    version on a call the piano made; the y bound is Y_TOL, x sqrt(V) with
    the mix."""
    import torch
    from oscen_tpu_torch.ops.cuda import additive as add
    outs_k = fn(*a, **kw)
    outs_p = add.plain_block(*a[:9], kw.get("with_mix", False), "v4")
    err = float((outs_k[0] - outs_p[0]).abs().max())
    same = all(torch.equal(u, v) for u, v in zip(outs_k[1:], outs_p[1:]))
    return err, same, float(outs_k[0].abs().max())


def voice_classes_phase(card):
    """Phase ``voice_classes``: the 256-voice piano behind a
    ``VoiceClassHost`` with classes (64, 128, 256) at B=1024, on a schedule
    that switches 256 -> 64 -> 128 -> 256 at event blocks; every block after
    the first (the switches too) under sync debug mode "error".  K1 against
    its plain version on the calls it made at V = 64, 128 and 256; the card
    against the port's class host on the CPU and against the full-capacity
    graph on the card; K1's device time per class, and a steady block's
    wall, busy time and device activities per class.  Returns the phase's
    K1 launches."""
    import torch
    from oscen_tpu_torch import raw_midi_event, tools
    from oscen_tpu_torch.models.electric_piano import build_electric_piano
    from oscen_tpu_torch.ops.cuda import additive as add
    from oscen_tpu_torch.utils.voice_classes import VoiceClassHost
    piano_env("v4")
    held = list(range(128)) + list(range(40, 52))        # 140 notes

    def make(device):
        return VoiceClassHost(build_electric_piano, capacities=VC_CAPS,
                              sample_rate=SR, block_size=VC_B,
                              tail_seconds=VC_TAIL, device=device)

    def play(target, blocks, on_card):
        ys = []
        for i, evs in enumerate(blocks):
            for e in evs:
                target.queue_event("midi_in", 0, raw_midi_event(e))
            with no_sync(on_card and i > 0):
                ys.append(target.process_block()["out"])
        return torch.cat(ys).cpu().numpy()

    # ---- the schedule on the card, the blocks decided as it runs ------
    reset_all()
    t0 = time.perf_counter()
    vc = make("cuda")
    seen, fns, restore = capture_calls(
        {"v4": (add, "additive_voice_block")})
    blocks, caps, k1_by_cap, ys = [], [], {}, []

    def step(evs):
        n = len(seen.get("v4", []))
        for e in evs:
            vc.queue_event("midi_in", 0, raw_midi_event(e))
        with no_sync(bool(blocks)):
            ys.append(vc.process_block()["out"])
        blocks.append(evs)
        caps.append(vc.active_cap)
        for a, _ in seen.get("v4", [])[n:]:
            V = int(a[0].shape[-1])
            k1_by_cap[V] = k1_by_cap.get(V, 0) + 1
    try:
        step([[0x90, k, 100] for k in held])                 # 256
        for _ in range(VC_STEADY):
            step([])
        step([[0x80, k, 0] for k in held])
        # the release tails count prepass blocks: an unheld note-off each
        for _ in range(int(VC_TAIL * SR) // VC_B + 4):
            step([[0x80, 0, 0]])
            if vc.active_cap == 64:
                break
        step([[0x90, k, 100] for k in range(40, 80)])        # 40 in 64
        for _ in range(VC_STEADY):
            step([])
        step([[0x90, k, 90] for k in range(20, 80)])         # -> 128
        for _ in range(VC_STEADY):
            step([])
        step([[0x90, k, 80] for k in range(30, 90)])         # -> 256
        for _ in range(VC_STEADY):
            step([])
    finally:
        restore()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    y_card = torch.cat(ys).cpu().numpy()
    k1 = add.launches["v4"]
    order = [c for i, c in enumerate(caps) if i == 0 or c != caps[i - 1]]
    # ---- K1 against its plain version on each class's last call -------
    k1_checks = {}
    for V in VC_CAPS:
        calls = [(a, kw) for a, kw in seen.get("v4", [])
                 if int(a[0].shape[-1]) == V]
        check(bool(calls), f"voice_classes: no K1 call at V={V} ({caps})")
        a, kw = calls[-1]
        err, same, y_max = k1_vs_plain(fns["v4"], a, kw)
        check(y_max > 0.01, f"voice_classes: K1 at V={V} ran silent voices")
        bound = Y_TOL * (math.sqrt(V) if kw.get("with_mix") else 1.0)
        k1_checks[V] = (err, same, bound, a, kw)
    # ---- the same blocks through the class host on the CPU and the
    # full-capacity graph on the card ----------------------------------
    y_cpu = play(make("cpu"), blocks, False)
    full = build_electric_piano(VOICES).compile(SR, block_size=VC_B,
                                                mode="block", device="cuda")
    y_full = play(full, blocks, True)
    peak = float(np.abs(y_full).max())
    err_cpu = float(np.abs(y_card - y_cpu).max())
    err_full = float(np.abs(y_card - y_full).max())
    checks = {
        "classes 256 -> 64 -> 128 -> 256": order == [256, 64, 128, 256],
        "switches": vc.switches == 3,
        "K1 at every class": all(k1_by_cap.get(V, 0) >= VC_STEADY
                                 for V in VC_CAPS),
        "K1 launches counted": k1 == sum(k1_by_cap.values()),
        "finite": bool(np.isfinite(y_card).all()),
        "card vs CPU class host": err_cpu <= MAIN_TOL,
        "card vs full capacity": err_full <= VC_FULL_TOL * peak,
    }
    for V, (err, same, bound, _, _) in k1_checks.items():
        checks[f"K1 V={V} y vs plain"] = err <= bound
        checks[f"K1 V={V} state vs plain (torch.equal)"] = same
    phase("voice_classes", f"piano 256 voices behind VoiceClassHost "
          f"{VC_CAPS} B={VC_B}, tail {VC_TAIL} s: {len(blocks)} blocks, "
          f"classes {caps}, {vc.switches} switches, every block after the "
          f"first under sync debug mode 'error', {secs:.1f} s; K1 launches "
          f"by V {k1_by_cap} (total {k1}); K1 vs plain "
          + "; ".join(f"V={V} y {e:.3e} (<= {b:.1e}) state equal {s}"
                      for V, (e, s, b, _, _) in k1_checks.items())
          + f"; peak {peak:.3f}; card vs the CPU class host {err_cpu:.3e} "
          f"(<= {MAIN_TOL:.0e}), vs the full-capacity graph {err_full:.3e} "
          f"(<= {VC_FULL_TOL * peak:.3e}); checks {checks}")
    check(all(checks.values()), f"voice_classes: {checks}")

    # ---- K1's device time per class, and a steady block per class ----
    for V in VC_CAPS:
        _, _, _, a, kw = k1_checks[V]
        B = int(a[8])
        us = tools.device_ms(lambda: fns["v4"](*a, **kw), 50,
                             kernel="additive_closed_kernel",
                             note=lambda m: phase("voice_classes", m)) * 1e3
        plain_us = tools.event_us(
            lambda: add.plain_block(*a[:9], kw.get("with_mix", False),
                                    "v4"), 3)
        b = bound_of("v4", a[:8], fns["v4"](*a, **kw), B,
                     int(a[0].shape[0]) * V)
        segs = add.segments(V, B, add.subgroup_len(B, "v4"))
        floor = tools.chain_floor_us("v4", B, VC_MHZ, segs)
        phase("voice_classes", f"K1 V={V} B={B} with_mix "
              f"{kw.get('with_mix')}: kernel {us:.2f} us (device), bound "
              f"{b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}), chain floor "
              f"{floor:.2f} us ({segs} segments at {VC_MHZ:.0f} MHz), plain "
              f"PyTorch {plain_us:.1f} us ({card})")
    from torch.profiler import ProfilerActivity, profile
    for V in VC_CAPS:
        p = build_electric_piano(V).compile(SR, block_size=VC_B,
                                            mode="block", device="cuda")
        for i in range(min(V, 60)):
            p.queue_event("midi_in", 0,
                          raw_midi_event([0x90, 36 + (i % 64), 100]))
        p.process_block()
        for _ in range(3):
            p.process_block()
        torch.cuda.synchronize()
        walls = []
        for _ in range(9):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            p.process_block()
            ev1.record()
            torch.cuda.synchronize()
            walls.append(ev0.elapsed_time(ev1))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                p.process_block()
            torch.cuda.synchronize()
        busy = acts = 0.0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                busy += getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0))
                acts += e.count
        wall = float(np.median(walls)) * 1e3
        busy /= 5.0
        phase("voice_classes", f"steady piano block at {V} voices B={VC_B}:"
              f" wall {wall:.1f} us (median of 9, CUDA events), device busy "
              f"{busy:.1f} us ({100 * busy / wall:.1f}%), {acts / 5:.0f} "
              f"device activities per block, real-time factor "
              f"{(VC_B / SR) / (wall * 1e-6):.1f}x ({card})")
    return {"v4": k1}


EX_SECONDS = 0.5
# the kernels each example's path launches (ops/cuda launch keys)
EX_KERNELS = {
    "electric_piano_demo": ("v4",),
    "fm_synth_demo": ("fract_phase3", "fm_chain3_scan"),
    "pivot_demo": ("pivot_chain3_scan",),
    "oversampled_saturator": ("phase_scan",),
    "render_convolution": (),
    "simple_synth": ("phase_scan", "tpt_svf_scan"),
    "streaming_host_demo": ("phase_scan", "tpt_svf_scan"),
}


def examples_phase(card, tmp):
    """Phase ``examples``: each of the seven examples through its ``main``
    for EX_SECONDS on the card and on the CPU, at the model's card-vs-CPU
    bound (PERF.md section 2), with the launches of its kernels counted
    over the card run, and each kernel held against its plain version on
    the example's last call.  Returns the launches by kernel."""
    import importlib
    import torch
    from oscen_tpu_torch.ops import conv as tconv
    from oscen_tpu_torch.ops import scan as oscan
    from oscen_tpu_torch.ops.cuda import additive as add
    from oscen_tpu_torch.ops.cuda import fm as kfm
    from oscen_tpu_torch.ops.cuda import iir as kiir
    from oscen_tpu_torch.ops.cuda import phase as kphase
    from oscen_tpu_torch.models import fm_synth as mfm
    from oscen_tpu_torch.models import pivot as mpivot
    from oscen_tpu_torch.nodes import filters as nfilters
    from oscen_tpu_torch.ops.cuda import launch_counters
    piano_env("v4")
    targets = {"v4": (add, "additive_voice_block"),
               "phase_scan": (oscan, "phase_scan"),
               "tpt_svf_scan": (nfilters, "tpt_svf_scan"),
               "fm_chain3_scan": (mfm, "fm_chain3_scan"),
               "pivot_chain3_scan": (mpivot, "pivot_chain3_scan")}
    plains = {"phase_scan": kphase.plain_phase_scan,
              "tpt_svf_scan": kiir.plain_tpt_svf_scan,
              "fm_chain3_scan": kfm.plain_fm_chain3_scan,
              "pivot_chain3_scan": kfm.plain_pivot_chain3_scan}
    totals = {}
    tol = {"electric_piano_demo": MAIN_TOL, "fm_synth_demo": POLY_TOL,
           "pivot_demo": POLY_TOL, "simple_synth": POLY_TOL,
           "streaming_host_demo": POLY_TOL}
    s = str(EX_SECONDS)
    for name, kernels in EX_KERNELS.items():
        ex = importlib.import_module(f"oscen_tpu_torch.examples.{name}")
        outs, secs = {}, {}
        for dev in ("cuda", "cpu"):
            out = f"{tmp}/{name}_{dev}"
            argv = {"streaming_host_demo": [s, "--out", out + ".wav"],
                    "render_convolution": ["", out + ".wav", "--seconds",
                                           str(EX_SECONDS / 2), "--tail",
                                           str(EX_SECONDS / 2)],
                    "oversampled_saturator": [out, "--seconds", s]
                    }.get(name, [out + ".wav", "--seconds", s])
            if dev == "cuda":
                reset_all()
                tconv.reset_launches()
                seen, fns, restore = capture_calls(targets)
            t0 = time.perf_counter()
            try:
                outs[dev] = ex.main(argv + ["--device", dev])
            finally:
                if dev == "cuda":
                    restore()
            secs[dev] = time.perf_counter() - t0
            if dev == "cuda":
                counts = {k: v for c in launch_counters() for k, v in c.items()
                          if v}
                ffts = dict(tconv.launches)
        # each kernel against its plain version on the example's last call
        vs_plain = {}
        for key, calls in seen.items():
            a, kw = calls[-1]
            if key == "v4":
                err, same, _ = k1_vs_plain(fns[key], a, kw)
                V = int(a[0].shape[-1])
                vs_plain[key] = same and err <= Y_TOL * (
                    math.sqrt(V) if kw.get("with_mix") else 1.0)
            else:
                vs_plain[key] = all(torch.equal(u, v) for u, v in zip(
                    fns[key](*a, **kw), plains[key](*a)))
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        got, want = outs["cuda"], outs["cpu"]
        peak = float(np.abs(want).max())
        bound = tol.get(name, TWIN_TOL * max(peak, 1.0))
        if name == "render_convolution":
            bound = REVERB_TOL * peak
        err = float(np.abs(got - want).max())
        checks = {"shape": got.shape == want.shape,
                  "finite": bool(np.isfinite(got).all()),
                  "not silent": peak > 0.01,
                  "card vs CPU": err <= bound,
                  "its kernels launched": all(counts.get(k, 0) > 0
                                              for k in kernels),
                  "kernels vs plain": all(vs_plain.values())}
        if name == "render_convolution":
            checks["no kernel, cuFFT only"] = (not counts
                                               and ffts.get("rfft", 0) > 0)
        phase("examples", f"{name} {EX_SECONDS} s: card {secs['cuda']:.1f} "
              f"s, CPU {secs['cpu']:.1f} s; peak {peak:.4f}, card vs CPU "
              f"{err:.3e} (<= {bound:.1e}); launches {counts}, FFT calls "
              f"{ffts}; kernels vs plain on the last call {vs_plain}; "
              f"checks {checks}")
        check(all(checks.values()), f"examples {name}: {checks}")
    phase("examples", f"launches on the examples' paths: {totals} ({card})")
    return totals


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from oscen_tpu_torch import raw_midi_event, tools
    from oscen_tpu_torch.models.electric_piano import build_electric_piano
    from oscen_tpu_torch.models.fm_synth import build_fm_synth
    from oscen_tpu_torch.models.pivot import build_pivot
    from oscen_tpu_torch.models.poly_synth import build_poly_synth
    from oscen_tpu_torch.models.simple import build_simple_synth
    from oscen_tpu_torch.nodes.envelope import _cached_steps
    from oscen_tpu_torch.ops.cuda import adsr as kadsr
    from oscen_tpu_torch.ops.cuda import additive as add
    from oscen_tpu_torch.ops.cuda import build
    from oscen_tpu_torch.ops.cuda import fm as kfm
    from oscen_tpu_torch.ops.cuda import iir as kiir
    from oscen_tpu_torch.ops.cuda import phase as kphase
    scans = {"phase_scan": kphase, "tpt_svf_scan": kiir, "adsr_scan": kadsr}

    # (lane, chunk)s phase_scan's short wrap re-ran with floor in each
    # model's main-path run (the device count after the run)
    main_reruns = {}

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
    from concurrent.futures import ThreadPoolExecutor
    libs = ("additive", "phase", "iir", "adsr", "fm", "kabl", "kabl_hmaj",
            "fractabl")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(build.load_library, libs))   # raises on failure
    phase("build", f"{len(libs)} sources built in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in libs:
        secs, log = build.build_info.get(name, (0.0, ""))
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        phase("build", f"{name}.cu (nvcc {secs:.2f} s): "
              + " | ".join(regs))
    sass_checks(build, tools)

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
            return add.plain_block(ore, oim, mre, mim, cur, tgt, mult, s, B,
                                   with_mix, version)
        return fn

    report = {}
    planes_np, step_np = additive_inputs(VOICES)
    planes = {k: on_card(v) for k, v in planes_np.items()}
    step = on_card(step_np)
    kept = {}   # the v4 and v3 kernel chains, to hold K3 to K1
    for version in add.KERNELS:
        rep = report.setdefault(version, {"max_abs_err": 0.0})
        for V, B in ADD_SHAPES:
            if V == VOICES:
                pl, st = planes, step
            else:
                pn, sn = additive_inputs(V)
                pl, st = {k: on_card(v) for k, v in pn.items()}, on_card(sn)
            for with_mix in (False, True):
                before = add.launches[version]
                yk, sk = chain(kernel_fn(version), pl, st, B, with_mix)
                torch.cuda.synchronize()
                check(add.launches[version] == before + 3,
                      f"{version}: launch counter did not advance")
                if version in ("v3", "v4"):
                    kept[(version, V, B, with_mix)] = yk + list(sk)
                yp, sp = chain(plain_fn(version), pl, st, B, with_mix)
                y_err = max(float((a - b).abs().max())
                            for a, b in zip(yk, yp))
                s_eq = all(torch.equal(a, b) for a, b in zip(sk, sp))
                y_tol = Y_TOL * (math.sqrt(V) if with_mix else 1.0)
                ok = y_err <= y_tol and s_eq
                phase("kernels", f"{version} V={V} B={B} "
                      f"with_mix={with_mix}: y max abs {y_err:.3e} "
                      f"(<= {y_tol:.1e}), state planes equal to the plain "
                      f"version's (torch.equal) {s_eq} "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok, f"{version} disagrees with its plain version")
                rep["max_abs_err"] = max(rep["max_abs_err"], y_err)
    for (version, V, B, with_mix), outs in kept.items():
        if version == "v3":
            same = all(torch.equal(a, b) for a, b in
                       zip(outs, kept[("v4", V, B, with_mix)]))
            phase("kernels", f"v3 V={V} B={B} with_mix={with_mix}: equal to "
                  f"v4 (torch.equal, y and state of 3 chained blocks) "
                  f"{'ok' if same else 'FAIL'}")
            check(same, "v3 and v4 kernels differ")
    del kept

    # v4 with the tremolo epilogue (K5): 3 chained blocks whose tremolo
    # tick count crosses K_REBASE in the first (the a2 branch of the phase)
    from oscen_tpu_torch import SampleRate, Tremolo
    trem = Tremolo()

    def trem_state(k0):
        return ({"anchor": on_card(np.float32(0.3)),
                 "k": torch.tensor(k0, dtype=torch.int32, device=dev),
                 "dt_last": on_card(np.float32(5.0 / SR))},
                {"rate": on_card(np.float32(5.0)),
                 "depth": on_card(np.float32(0.3))})

    rep = report.setdefault(add.EPILOGUE, {"max_abs_err": 0.0})
    for V, B in ADD_SHAPES:
        pn, sn = (planes_np, step_np) if V == VOICES else additive_inputs(V)
        ore, oim, mr, mi, cur, tgt, mult = (on_card(pn[k]) for k in (
            "osc_re", "osc_im", "mul_re", "mul_im", "cur", "tgt", "mult"))
        s = on_card(sn)
        k0 = add.K_REBASE - B // 2
        tst, vals = trem_state(k0)
        for _ in range(3):
            C, fn, prm, new_t = trem.kernel_epilogue(tst, vals,
                                                     SampleRate(SR), B)
            before = add.launches[add.EPILOGUE]
            k_out = add.additive_voice_block(
                ore, oim, mr, mi, cur, tgt, mult, s, B, with_mix=True,
                epi_fn=fn, epi_c=C, epi_params=prm)
            torch.cuda.synchronize()
            check(add.launches[add.EPILOGUE] == before + 1,
                  "v4_epilogue: launch counter did not advance")
            p_out = add.plain_block(ore, oim, mr, mi, cur, tgt, mult, s, B,
                                    True, "v4")
            y_err = float((k_out[0] - torch.stack(fn(p_out[0], 0, prm),
                                                  dim=-1)).abs().max())
            s_eq = all(torch.equal(a, b) for a, b in zip(k_out[1:],
                                                         p_out[1:]))
            k1 = add.additive_voice_block(ore, oim, mr, mi, cur, tgt, mult,
                                          s, B, with_mix=True, version="v4")
            as_k1 = torch.equal(k_out[0], torch.stack(fn(k1[0], 0, prm),
                                                      dim=-1))
            ref_st, ref_out = trem.process_block(
                tst, {"input": k1[0], "rate": vals["rate"].expand(B),
                      "depth": vals["depth"].expand(B)}, {},
                SampleRate(SR), B, const_ins=frozenset({"rate", "depth"}))
            as_node = torch.equal(k_out[0], ref_out["output"]) and all(
                torch.equal(new_t[k], ref_st[k]) for k in ref_st)
            y_tol = Y_TOL * math.sqrt(V)
            ok = y_err <= y_tol and s_eq and as_k1 and as_node
            rep["max_abs_err"] = max(rep["max_abs_err"], y_err)
            phase("kernels", f"v4_epilogue V={V} B={B} tremolo ticks "
                  f"{int(tst['k'])}..{int(tst['k']) + B - 1} (K_REBASE "
                  f"{add.K_REBASE}): y max abs {y_err:.3e} (<= "
                  f"{y_tol:.1e}), state equal {s_eq}, equal to v4's mix "
                  f"panned by the plain version {as_k1}, equal to Tremolo."
                  f"process_block (output and state) {as_node} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, "v4_epilogue disagrees with its plain version")
            tst = new_t
            _, ore, oim, cur, tgt, s = k_out

    # K1's time segments: v4 with and without the mix, and with the
    # epilogue, at ragged V and B against the plain version at its bounds;
    # every segment count's outputs equal to the shipped choice's
    t0 = time.perf_counter()
    seg_used = {}
    for V in SEG_V:
        pn, sn = additive_inputs(V, seed=V)
        pl = [on_card(pn[k]) for k in ("osc_re", "osc_im", "mul_re",
                                       "mul_im", "cur", "tgt", "mult")]
        s = on_card(sn)
        for B in SEG_B:
            sub = add.subgroup_len(B, "v4")
            S = add.segments(V, B, sub)
            seg_used[(V, B)] = S
            y_tol = {m: Y_TOL * (math.sqrt(V) if m else 1.0)
                     for m in (False, True)}
            mixes = {}
            for with_mix in (False, True):
                k_out = add.additive_voice_block(*pl, s, B,
                                                 with_mix=with_mix,
                                                 version="v4")
                p_out = add.plain_block(*pl, s, B, with_mix, "v4")
                torch.cuda.synchronize()
                y_err = float((k_out[0] - p_out[0]).abs().max())
                ok = y_err <= y_tol[with_mix] and all(
                    torch.equal(a, b) for a, b in zip(k_out[1:], p_out[1:]))
                for S2 in (1, 2, 4):
                    if (B // sub) % S2 == 0:
                        o2 = add.block_segments(*pl, s, B, S2, with_mix)
                        ok = ok and all(torch.equal(a, b)
                                        for a, b in zip(o2, k_out))
                check(ok, f"v4 V={V} B={B} with_mix={with_mix} ({S} "
                      f"segments): y max abs {y_err:.3e} (<= "
                      f"{y_tol[with_mix]:.1e}), or a state plane, or another "
                      f"segment count differs")
                mixes[with_mix] = k_out[0]
            if add.EPILOGUE_TILE >= V + (-V % 128):
                tst, vals = trem_state(add.K_REBASE - B // 2)
                C, fn, prm, _ = trem.kernel_epilogue(tst, vals,
                                                     SampleRate(SR), B)
                e_out = add.additive_voice_block(*pl, s, B, with_mix=True,
                                                 epi_fn=fn, epi_c=C,
                                                 epi_params=prm)
                torch.cuda.synchronize()
                check(torch.equal(e_out[0], torch.stack(
                    fn(mixes[True], 0, prm), dim=-1)),
                    f"v4_epilogue V={V} B={B}: not v4's mix panned")
    phase("kernels", f"v4 (with and without the mix) and v4_epilogue at V in "
          f"{SEG_V}, B in {SEG_B} against the plain version (y <= 5e-5, x "
          f"sqrt(V) with the mix; state torch.equal), every segment count "
          f"equal to the shipped one, the epilogue equal to v4's mix panned "
          f"(V <= 256) ok; segments used (V, B): {seg_used} "
          f"({time.perf_counter() - t0:.1f} s)")

    # K3, K4 and K2 (and K1) with ODD_STEPS in voices 3-20 of the piano's
    # shapes: every segment count equal to one warp per voice, the state
    # equal to the plain version's, NaN equal to NaN; y of every voice
    # whose plain rows are finite within Y_TOL of its largest |y| (at least
    # 1: the 2^24 step's first tick reaches ~1e6)
    def same_nan(a, b):
        def eq(x, y):
            nx, ny = torch.isnan(x), torch.isnan(y)
            return torch.equal(nx, ny) and torch.equal(x[~nx], y[~ny])
        return all(eq(x, y) for x, y in zip(a, b))

    t0 = time.perf_counter()
    pn, sn = additive_inputs(VOICES)
    sn[3:3 + len(ODD_STEPS)] = ODD_STEPS
    pl = [on_card(pn[k]) for k in ("osc_re", "osc_im", "mul_re", "mul_im",
                                   "cur", "tgt", "mult")]
    s = on_card(sn)
    finite = {}
    for version in ("v3", "v2", "v4", "parity"):
        for B in BLOCKS:
            for with_mix in (False, True):
                one = add.block_segments(*pl, s, B, 1, with_mix, version)
                for S2 in (2, 4):
                    got = add.block_segments(*pl, s, B, S2, with_mix,
                                             version)
                    torch.cuda.synchronize()
                    check(same_nan(got, one),
                          f"{version} B={B} with_mix={with_mix}, entry steps "
                          f"off the cycle: {S2} segments differ from one "
                          f"warp per voice")
            k_out = add.additive_voice_block(*pl, s, B, version=version)
            p_out = add.plain_block(*pl, s, B, False, version)
            torch.cuda.synchronize()
            fin = torch.isfinite(p_out[0]).all(dim=0)
            yp = p_out[0][:, fin]
            scale = yp.abs().amax(dim=0).clamp(min=1.0)
            y_ok = bool(((k_out[0][:, fin] - yp).abs() <= Y_TOL * scale)
                        .all())
            finite[(version, B)] = int(fin.sum())
            check(same_nan(k_out[1:], p_out[1:]) and y_ok,
                  f"{version} B={B}, entry steps off the cycle: the state "
                  f"or a finite voice's y differs from the plain version")
    phase("kernels", f"v3, v2, v4 and parity at V={VOICES}, B in {BLOCKS} "
          f"with entry steps {ODD_STEPS} in voices 3-20: 2 and 4 segments "
          f"equal to one "
          f"warp per voice (NaN equal to NaN) with and without the mix; "
          f"state equal to the plain version's (NaN equal to NaN), y within "
          f"{Y_TOL:.0e} of each voice's largest |y| (at least 1) for the "
          f"voices whose plain rows are finite {finite} ok "
          f"({time.perf_counter() - t0:.1f} s)")

    # the scan kernels: torch.equal on every output of 3 chained blocks
    rng = np.random.default_rng(1)

    def rand(lo, hi, shape):
        return on_card(rng.uniform(lo, hi, shape).astype(np.float32))

    def adsr_inputs(V):
        """The parameter rows of tests/test_pallas.py:274-280 tiled across
        V voices and perturbed by +-10%; gate-on state (attack from 0 at
        velocity 0.8)."""
        base = np.array([[0.0005, 0.0010, 0.60, 0.0015],
                         [0.0020, 0.0005, 0.25, 0.0008],
                         [0.0010, 0.0030, 0.90, 0.0030]], np.float32)
        pv = np.tile(base, (-(-V // 3), 1))[:V]
        pv = pv * rng.uniform(0.9, 1.1, pv.shape).astype(np.float32)
        p = {k: on_card(pv[:, i]) for i, k in
             enumerate(("attack", "decay", "sustain", "release"))}
        a_n, d_n, r_n, a_c, d_c = _cached_steps(p, SR)
        rows = [a_n.float(), d_n.float(), r_n.float(), a_c, d_c]
        st = torch.zeros(7, V, device=dev)
        st[0], st[1], st[3], st[5] = 1.0, rows[0], 1.0, 0.8
        return st, rows, p["sustain"]

    def gate_off(st, rows):
        """set_stage(RELEASE) on state7: release from the current level."""
        st = st.clone()
        lvl = st[2].clamp(0.0, 1.0)
        st[0], st[1], st[3] = 4.0, rows[2], 0.0
        st[6] = torch.where(lvl <= 0.0, 0.0, -lvl / rows[2].clamp(min=1.0))
        return st

    def scan_case(name, V, B, per_sample=False):
        """Chained blocks of kernel and plain version on the same inputs;
        returns the largest difference (0.0 when bit-equal)."""
        mod = scans[name]
        fn = getattr(mod, name)
        plain = getattr(mod, "plain_" + name)
        if name == "phase_scan":
            carry = rand(0, 1, (V,))
            blocks = [(rand(0, 0.3, (B, V)),) for _ in range(3)]
        elif name == "tpt_svf_scan":
            carry = (rand(-1, 1, (V,)), rand(-1, 1, (V,)))
            cs = (B, V) if per_sample else (V,)
            blocks = [(rand(-1, 1, (B, V)), rand(0.3, 0.9, cs),
                       rand(0.05, 0.5, cs), rand(1.0, 2.0, cs))
                      for _ in range(3)]
        else:
            carry, rows, sus = adsr_inputs(V)
            n_on = -(-300 // B)   # through A -> D -> S
            n_blocks = max(3, n_on + -(-200 // B))
            sus_p = sus[None].expand(B, V).contiguous()
        err = 0.0
        before = mod.launches[name]
        for i in range(n_blocks if name == "adsr_scan" else 3):
            if name == "phase_scan":
                args = (carry, blocks[i][0])
            elif name == "tpt_svf_scan":
                args = (*blocks[i], *carry)
            else:
                if i == n_on:
                    check(bool((carry[0] == 3.0).all()),
                          "adsr_scan: not every voice reached sustain")
                    carry = gate_off(carry, rows)
                args = (carry, *rows, sus_p)
            k_out = fn(*args)
            torch.cuda.synchronize()
            p_out = plain(*args)
            for a, b in zip(k_out, p_out):
                if not torch.equal(a, b):
                    err = max(err, float((a - b).abs().max()))
                    check(False, f"{name} V={V} B={B}: kernel and plain "
                          f"version differ by {err:.3e}")
            carry = k_out[1] if name != "tpt_svf_scan" else k_out[1:]
        check(mod.launches[name] == before + i + 1,
              f"{name}: launch counter did not advance")
        if name == "adsr_scan":
            check(bool((carry[0] == 0.0).all()),
                  "adsr_scan: not every voice returned to idle")
        return err

    for name in scans:
        rep = report.setdefault(name, {"max_abs_err": 0.0})
        for V, B in SCAN_SHAPES:
            for per_sample in ((False, True) if name == "tpt_svf_scan"
                               else (False,)):
                err = scan_case(name, V, B, per_sample)
                rep["max_abs_err"] = max(rep["max_abs_err"], err)
                what = (" per-sample coefficients" if per_sample else
                        " row coefficients" if name == "tpt_svf_scan"
                        else "")
                phase("kernels", f"{name} V={V} B={B}{what}: equal to the "
                      f"plain version (torch.equal, every output of 3+ "
                      f"chained blocks) ok")

    # the FM kernels: torch.equal on every output of 3 chained blocks
    def fm_args(name, V, B, rng_f, per_sample=False, fb=0.4):
        """One block's operands after the carries: nonzero feedback, a
        per-sample pitch step (a note-on) or block-constant dt for the
        chains; per-sample planes for the operator."""
        def r(lo, hi, shape):
            return on_card(rng_f.uniform(lo, hi, shape).astype(np.float32))
        if name == "fract_phase3":
            return (r(-0.05, 0.4, (3, V)), B)
        if name == "fm_operator_scan":   # dt, pm, fb, env, lvl
            return tuple(r(lo, hi, (B, V)) for lo, hi in (
                (0.002, 0.03), (-0.2, 0.2), (0.0, 0.6), (0.1, 1.0),
                (0.3, 1.0)))
        freq = np.broadcast_to(rng_f.uniform(100, 1000, V), (B, V)).copy()
        if per_sample:
            freq[B // 3:, ::2] *= 1.5
        dt = np.stack([freq * k / SR for k in (3.0, 2.0, 1.0)])
        return (on_card(dt.astype(np.float32) if per_sample
                        else dt[:, :1].astype(np.float32)),
                r(0.3, 1.0, (3, V)), r(0.0, fb, (3, V)), r(0.0, 1.0, (V,)),
                *(r(0.1, 1.0, (B, V)) for _ in range(3)))

    def fm_carry(name, V, rng_f):
        def r(lo, hi, shape):
            return on_card(rng_f.uniform(lo, hi, shape).astype(np.float32))
        if name == "fract_phase3":
            return (r(-1, 1, (3, V)),)
        if name == "fm_operator_scan":
            return (r(0, 1, (V,)), r(-1, 1, (V,)))
        return (r(0, 1, (3, V)), r(-1, 1, (3, V)))

    def fm_case(name, V, B, per_sample=False):
        """3 chained blocks of kernel and plain version on the same
        operands; any difference fails the run."""
        fn, plain = getattr(kfm, name), getattr(kfm, "plain_" + name)
        rng_f = np.random.default_rng(V + B + per_sample)
        carry = fm_carry(name, V, rng_f)
        before = kfm.launches[name]
        for _ in range(3):
            args = fm_args(name, V, B, rng_f, per_sample)
            k_out = fn(*carry, *args)
            torch.cuda.synchronize()
            p_out = plain(*carry, *args)
            for a, b in zip(k_out, p_out):
                if not torch.equal(a, b):
                    check(False, f"{name} V={V} B={B}: kernel and plain "
                          f"version differ by "
                          f"{float((a - b).abs().max()):.3e}")
            carry = k_out[3:] if name == "fract_phase3" else k_out[1:]
        check(kfm.launches[name] == before + 3,
              f"{name}: launch counter did not advance")

    for name in kfm.KERNELS:
        report[name] = {"max_abs_err": 0.0}
        # the chains' operators run a chunk apart: blocks shorter than the
        # skew and around a chunk too
        shapes = SCAN_SHAPES + (CHAIN_EDGES if "chain" in name else ())
        for V, B in shapes:
            for per_sample in ((False, True) if "chain" in name
                               else (False,)):
                fm_case(name, V, B, per_sample)
                what = ({True: " per-sample dt, feedback",
                         False: " block-constant dt, feedback"}[per_sample]
                        if "chain" in name else " per-sample fb/lvl"
                        if "operator" in name else "")
                phase("kernels", f"{name} V={V} B={B}{what}: equal to the "
                      f"plain version (torch.equal, every output of 3 "
                      f"chained blocks) ok")

    # K12's two loops: lanes on its short wrap (p0 and dt in [+0, 1)), off
    # it (the edges among them) and both in every warp, 3 chained blocks
    # against the plain version on the bit patterns (NaN equal to its own
    # pattern only); its short wrap over all 2^32 q against q - trunc(q)
    t0 = time.perf_counter()
    for lanes in FRACT_LANES:
        for B in BLOCKS:
            rng_f = np.random.default_rng(B + len(lanes))
            p, dt = fract_inputs(lanes, VOICES, rng_f)
            for _ in range(3):
                k_out = kfm.fract_phase3(p, dt, B)
                torch.cuda.synchronize()
                check(same_bits(k_out, kfm.plain_fract_phase3(p, dt, B)),
                      f"fract_phase3 {lanes} lanes B={B}: kernel and plain "
                      f"version differ")
                p = k_out[3]
                dt = fract_inputs(lanes, VOICES, rng_f)[1]
    wrong, taken = kfm.wrap_sweep()
    check(wrong == 0 and taken == 2 ** 30,
          f"fract_phase3's short wrap: {wrong} of 2^32 patterns differ from "
          f"q - trunc(q), {taken} taken (want 0 and 2^30)")
    phase("kernels", f"fract_phase3 with lanes {FRACT_LANES} at V={VOICES}, "
          f"B in {BLOCKS}: equal to the plain version (bit patterns, 3 "
          f"chained blocks) ok; its short wrap over all 2^32 float32 q: "
          f"{wrong} differ from q - trunc(q), {taken} taken ok "
          f"({time.perf_counter() - t0:.1f} s)")

    # the chains' zero-feedback branch (fract_phase3 + plain PyTorch) is
    # bit-equal to their sequential kernels, so the branch choice never
    # changes the numbers
    for kind in ("fm", "pivot"):
        scan = getattr(kfm, f"{kind}_chain3_scan")
        for V, B in ((VOICES, 1024), (VOICES, 4096)):
            rng_f = np.random.default_rng(B)
            fast = seq = fm_carry("chain", V, rng_f)
            for _ in range(3):
                args = fm_args("chain", V, B, rng_f, fb=0.0)
                f_out = scan(*fast, *args, fb_zero=True)
                s_out = scan(*seq, *args)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(f_out, s_out)),
                      f"{kind} zero-feedback branch differs from the "
                      f"chain kernel at V={V} B={B}")
                fast, seq = f_out[1:], s_out[1:]
            phase("kernels", f"{kind} zero-feedback branch V={V} B={B}: "
                  f"equal to {kind}_chain3_scan (torch.equal, 3 chained "
                  f"blocks) ok")

    # the filter kernels: torch.equal on every output of 3 chained blocks
    def biquad_rows(rng_q, shape):
        """JUCE lowpass coefficients (iir_lowpass/mod.rs:84-100) for random
        cutoffs at q = 1/sqrt(2), in float64, rounded once."""
        cut = rng_q.uniform(1500.0, 8000.0, shape)
        n = 1.0 / np.tan(np.pi * cut / SR)
        r2 = math.sqrt(2.0)
        c1 = 1.0 / (1.0 + r2 * n + n * n)
        return [on_card(np.asarray(c, np.float32)) for c in
                (c1, 2 * c1, c1, 2 * c1 * (1 - n * n),
                 c1 * (1 - r2 * n + n * n))]

    def filter_case(name, V, B, per_sample):
        """3 chained blocks of kernel and plain version on the same
        operands (any difference fails the run).  The LP18 gets inputs that
        drive its tanh into saturation and returns the largest |z0|; the
        biquad's last block decays below 1e-15, and it returns the share
        of exact zeros (fired snaps) in its last 100 samples."""
        rng_f = np.random.default_rng(V + B + per_sample)

        def r(lo, hi, shape):
            return on_card(rng_f.uniform(lo, hi, shape).astype(np.float32))
        shape = (B, V) if per_sample else (V,)
        fn, plain = getattr(kiir, name), getattr(kiir, "plain_" + name)
        if name == "lp18_scan":
            carry = (r(-0.8, 0.8, (3, V)),)
        else:
            carry = (r(-1, 1, (V,)), r(-1, 1, (V,)))
            coefs = biquad_rows(rng_f, shape)
        before = kiir.launches[name]
        z0_max = 0.0
        for i in range(3):
            x = rng_f.standard_normal((B, V))
            if name == "lp18_scan":
                args = (on_card((3.0 * x).astype(np.float32)),
                        r(0.01, 0.9, shape), r(0.0, 1.98, shape))
            else:
                if i == 2:
                    x = x * np.exp(-np.arange(B) / 4.0)[:, None]
                args = (on_card(x.astype(np.float32)), *coefs)
            k_out = fn(*args, *carry)
            torch.cuda.synchronize()
            p_out = plain(*args, *carry)
            for a, b in zip(k_out, p_out):
                if not torch.equal(a, b):
                    check(False, f"{name} V={V} B={B}: kernel and plain "
                          f"version differ by "
                          f"{float((a - b).abs().max()):.3e}")
            carry = k_out[1:]
            if name == "lp18_scan":
                z0_max = max(z0_max, float(carry[0][0].abs().max()))
        check(kiir.launches[name] == before + 3,
              f"{name}: launch counter did not advance")
        if name == "lp18_scan":
            return z0_max
        return float((k_out[0][-min(B, 100):] == 0).float().mean())

    for name in ("lp18_scan", "biquad_scan"):
        report[name] = {"max_abs_err": 0.0}
        for V, B in FILTER_SHAPES:
            for per_sample in (False, True):
                info = filter_case(name, V, B, per_sample)
                if name == "biquad_scan" and B >= 1024:
                    check(info > 0.0, f"biquad_scan V={V} B={B}: the "
                          f"denormal snaps never fired")
                form = "per-sample" if per_sample else "row"
                phase("kernels", f"{name} V={V} B={B} {form} coefficients: "
                      f"equal to the plain version (torch.equal, every "
                      f"output of 3 chained blocks) ok; " + (
                          f"largest |z0| (the tanh's output) {info:.4f}"
                          if name == "lp18_scan" else
                          f"exact zeros in the last samples of the decaying "
                          f"block {100 * info:.1f}%"))

    ring_checks(torch, dev, kiir)
    k9_k14_ring_checks(torch, dev, kiir, kfm)
    phase_checks(torch, dev, kphase)

    # the allpass cascade: torch.equal on every output of 3 chained blocks,
    # per-lane betas (the halfband branches side by side)
    from oscen_tpu_torch.ops.resample import BRANCH_A_BETAS, BRANCH_B_BETAS

    def allpass_coefs(V):
        betas = np.array([BRANCH_A_BETAS, BRANCH_B_BETAS], np.float32).T
        return on_card(np.ascontiguousarray(np.tile(betas, (1, V))[:, :V]))

    def allpass_operands(V, B, rng_a):
        return (on_card(rng_a.standard_normal((B, V)).astype(np.float32)),
                allpass_coefs(V),
                *(on_card(rng_a.uniform(-1, 1, (2, V)).astype(np.float32))
                  for _ in range(2)))

    report["allpass_cascade_scan"] = {"max_abs_err": 0.0}
    for V, B in ALLPASS_SHAPES + ALLPASS_EDGES:
        rng_a = np.random.default_rng(V + B)
        _, a, *carry = allpass_operands(V, B, rng_a)
        before = kiir.launches["allpass_cascade_scan"]
        for _ in range(3):
            x = on_card(rng_a.standard_normal((B, V)).astype(np.float32))
            k_out = kiir.allpass_cascade_scan(x, a, *carry)
            torch.cuda.synchronize()
            p_out = kiir.plain_allpass_cascade_scan(x, a, *carry)
            for u, w in zip(k_out, p_out):
                if not torch.equal(u, w):
                    check(False, f"allpass_cascade_scan V={V} B={B}: kernel "
                          f"and plain version differ by "
                          f"{float((u - w).abs().max()):.3e}")
            carry = k_out[1:]
        check(kiir.launches["allpass_cascade_scan"] == before + 3,
              "allpass_cascade_scan: launch counter did not advance")
        phase("kernels", f"allpass_cascade_scan V={V} B={B}: equal to the "
              f"plain version (torch.equal, every output of 3 chained "
              f"blocks) ok")

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
        if device == "cuda":   # a steady block must not wait for the card
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            blocks += [p.process_block()["out"] for _ in range(8)]
        finally:
            if device == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        release_half(p)
        blocks.append(p.process_block()["out"])
        steady = p.render_steady(16)["out"]
        ck = p.steady_checksum(32)
        return p, blocks, steady, ck

    # one run per kernel version, and v4 with the tremolo epilogue fused
    RUNS = add.KERNELS + (add.EPILOGUE,)

    main_out = {}
    launches = {}
    for version in RUNS:
        piano_env(version)
        reset_all()
        t0 = time.perf_counter()
        p, blocks, steady, ck = drive("cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        main_out[version] = (blocks, steady)
        launches[version] = dict(add.launches)
        if version == add.EPILOGUE:
            notes = p.explain()
            fused = ({"node": "tremolo",
                      "path": "fused_into_producer_epilogue"} in notes
                     and {"node": "voices",
                          "epilogue_fused_consumer": "tremolo"} in notes)
            still = dict(add.launches) == launches[version]
            phase("main", f"{version}: explain() shows the tremolo fused "
                  f"into the voice kernel {fused}; launch counters "
                  f"unchanged by explain() {still}")
            check(fused and still, "epilogue fusion: explain() check")
        audio = torch.cat(blocks + [steady]).cpu().numpy()
        leaves = []

        def walk(t):
            if isinstance(t, dict):
                for v in t.values():
                    walk(v)
            elif isinstance(t, (tuple, list)):
                for v in t:
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
              f"blocks (the 8 under sync debug mode 'error'), checksum "
              f"{ck:.6e}, peak {float(np.abs(audio).max()):.4f}, "
              f"{secs:.2f} s; checks {checks}")
        check(all(checks.values()), f"main path checks failed: {checks}")
    steady_blocks = 8 + 16 + 32
    phase("main", f"kernel launches in the main-path runs: {launches} "
          f"(steady blocks per run: {steady_blocks})")
    for version in RUNS:
        want = {k: steady_blocks if k == version else 0 for k in add.launches}
        check(launches[version] == want,
              f"{version}: launches {launches[version]}, want {want}")

    def whole(run):
        return torch.cat(main_out[run][0] + [main_out[run][1]])
    v4_all, par_all = whole("v4"), whole("parity")
    rel = float(torch.sqrt(torch.mean((v4_all - par_all) ** 2))
                / torch.sqrt(torch.mean(par_all ** 2)))
    phase("main", f"v4 against parity over the run: relative RMS {rel:.3e}")
    for run in ("v3", add.EPILOGUE):
        same = torch.equal(whole(run), v4_all)
        phase("main", f"{run} run equal to the v4 run (torch.equal, "
              f"{v4_all.shape[0]} samples x 2) {'ok' if same else 'FAIL'}")
        check(same, f"the {run} piano differs from the v4 piano")
    rel2 = float(torch.sqrt(torch.mean((whole("v2") - par_all) ** 2))
                 / torch.sqrt(torch.mean(par_all ** 2)))
    phase("main", f"v2 against parity over the run: relative RMS {rel2:.3e}")

    # the same sequence on the CPU (plain versions), first 4 blocks
    for version in RUNS:
        piano_env(version)
        p = build_electric_piano(VOICES).compile(SR, block_size=1024,
                                                 mode="block", device="cpu")
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
    os.environ.pop("OSCEN_EPILOGUE_FUSION", None)

    # the 256-voice poly synth
    def poly_chord(p):
        for i in range(VOICES):
            p.queue_event("midi_in", 0,
                          raw_midi_event([0x90, 36 + (i % 64), 100]))

    def poly_drive(device, B=1024, sync_check=False):
        p = build_poly_synth(VOICES).compile(SR, block_size=B,
                                             device=device)
        poly_chord(p)
        blocks = [p.process_block()["audio_out"]]
        if sync_check:   # a steady block must not wait for the card
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            blocks += [p.process_block()["audio_out"] for _ in range(8)]
        finally:
            if sync_check:
                torch.cuda.set_sync_debug_mode("default")
        release_half(p)
        blocks.append(p.process_block()["audio_out"])
        return p, blocks

    reset_all()
    t0 = time.perf_counter()
    p, blocks = poly_drive("cuda", sync_check=True)
    steady = p.render_steady(16)["audio_out"]
    ck = p.steady_checksum(32)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    poly_launches = {k: mod.launches[k] for k, mod in scans.items()}
    main_reruns["poly synth"] = kphase.take_reruns()
    poly_blocks = 1 + 8 + 1 + 16 + 32
    audio = torch.cat(blocks + [steady]).cpu().numpy()
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        else:
            leaves.append(t)
    walk(p.state)
    checks = {
        "shape": tuple(blocks[0].shape) == (1024,)
        and blocks[0].device.type == "cuda",
        "finite": bool(np.isfinite(audio).all()) and math.isfinite(ck),
        "peak": 0.01 < float(np.abs(audio).max()) < 2.0,
        "state_on_cuda": all(x.device.type == "cuda" for x in leaves),
        "steady_blocks_never_synced": True,   # else set_sync_debug_mode
    }
    phase("main", f"poly synth: 256 voices B=1024, 8 steady blocks under "
          f"sync debug mode 'error', half released, 16+32 steady blocks, "
          f"checksum {ck:.6e}, peak {float(np.abs(audio).max()):.4f}, "
          f"{secs:.2f} s; checks {checks}")
    check(all(checks.values()), f"poly-synth checks failed: {checks}")
    phase("main", f"poly synth: kernel launches {poly_launches} "
          f"(process_block + steady blocks: {poly_blocks}; adsr_scan is "
          f"not wired into AdsrEnvelope, as in the JAX package)")
    for name in ("phase_scan", "tpt_svf_scan"):
        check(poly_launches[name] == poly_blocks,
              f"{name}: {poly_launches[name]} launches, want {poly_blocks}")
    _, cpu_blocks = poly_drive("cpu")
    errs = [float((a.cpu() - b).abs().max())
            for a, b in zip(blocks[:4], cpu_blocks[:4])]
    phase("main", f"poly synth: card against CPU, first 4 blocks: max abs "
          f"per block {['%.3e' % e for e in errs]} (<= {POLY_TOL:.0e}; "
          f"CPU peak {float(torch.cat(cpu_blocks).abs().max()):.4f})")
    check(max(errs) <= POLY_TOL, "poly synth: card and CPU runs disagree")

    # the 256-voice fm synth and pivot
    def fm_drive(build, device, B=1024, sync_check=False):
        """The chord, 8 steady blocks (under sync debug mode "error" when
        ``sync_check``); the pivot then sets op3_feedback to 0.3 (its
        steady blocks run pivot_chain3_scan) and runs 1 + 4 more; half
        the notes released."""
        p = build(VOICES).compile(SR, block_size=B, device=device)
        poly_chord(p)
        blocks = [p.process_block()["audio_out"]]

        def steady(n):
            if sync_check:   # a steady block must not wait for the card
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                return [p.process_block()["audio_out"] for _ in range(n)]
            finally:
                if sync_check:
                    torch.cuda.set_sync_debug_mode("default")
        blocks += steady(8)
        if build is build_pivot:
            p.set_value("op3_feedback", 0.3)
            blocks.append(p.process_block()["audio_out"])   # restaged
            blocks += steady(4)
        release_half(p)
        blocks.append(p.process_block()["audio_out"])
        return p, blocks

    fm_launches = {}
    for model, build, chain_kernel in (
            ("fm synth", build_fm_synth, "fm_chain3_scan"),
            ("pivot", build_pivot, "pivot_chain3_scan")):
        reset_all()
        t0 = time.perf_counter()
        p, blocks = fm_drive(build, "cuda", sync_check=True)
        steady = p.render_steady(16)["audio_out"]
        ck = p.steady_checksum(32)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: kfm.launches[k] for k in ("fract_phase3", chain_kernel)}
        got["tpt_svf_scan"] = kiir.launches["tpt_svf_scan"]
        fm_launches[model] = got
        n_blocks = len(blocks) + 16 + 32
        audio = torch.cat(blocks + [steady]).cpu().numpy()
        leaves = []
        walk(p.state)
        checks = {
            "shape": tuple(blocks[0].shape) == (1024,)
            and blocks[0].device.type == "cuda",
            "finite": bool(np.isfinite(audio).all()) and math.isfinite(ck),
            "peak": 0.01 < float(np.abs(audio).max()) < 1000.0,
            "state_on_cuda": all(x.device.type == "cuda" for x in leaves),
            "steady_blocks_never_synced": True,   # else set_sync_debug_mode
            "both_branches_ran": got["fract_phase3"] > 0
            and got[chain_kernel] > 0,
            "filter_every_block": got["tpt_svf_scan"] == n_blocks,
        }
        phase("main", f"{model}: 256 voices B=1024, 8 steady blocks under "
              f"sync debug mode 'error'"
              + (", op3_feedback 0.3 then 4 more" if model == "pivot"
                 else "")
              + f", half released, 16+32 steady blocks, checksum "
              f"{ck:.6e}, peak {float(np.abs(audio).max()):.4f}, "
              f"{secs:.2f} s; checks {checks}")
        check(all(checks.values()), f"{model} checks failed: {checks}")
        phase("main", f"{model}: kernel launches {got} ({n_blocks} blocks)")
        _, cpu_blocks = fm_drive(build, "cpu")
        errs = [float((a.cpu() - b).abs().max())
                for a, b in zip(blocks, cpu_blocks)]
        phase("main", f"{model}: card against CPU, first 4 blocks: max abs "
              f"per block {['%.3e' % e for e in errs[:4]]} (<= "
              f"{POLY_TOL:.0e}; CPU peak "
              f"{float(torch.cat(cpu_blocks).abs().max()):.4f}); all "
              f"{len(errs)} blocks: {max(errs):.3e}")
        check(max(errs[:4]) <= POLY_TOL, f"{model}: card and CPU disagree")

    def steady_busy(label, step, B):
        """A steady block's wall (CUDA events around 20 blocks) and device
        busy time (the profiler's sum over all device activity; no device
        time fails the run), read in the phase that drives the graph: late
        in a long process the profiler drops its device records."""
        step()
        wall = tools.chain_us(lambda _: step(), None, 20)
        try:
            busy, top, n_kern = tools.device_ms(
                step, 20, top=4, note=lambda m: phase("main", m))
        except RuntimeError as e:
            check(False, f"{label} B={B}: {e}")
        phase("main", f"{label} B={B}: steady block {wall:.1f} us "
              f"(events), device busy {busy * 1e3:.1f} us "
              f"({100 * busy * 1e3 / wall:.1f}%), {n_kern:.0f} device "
              f"activities per block ({card}); top: " + "; ".join(
                  f"{k[:50]} {t * 1e3:.1f} us x{c:.0f}" for k, t, c in top))

    # the unfused fm synth: FmOperator node arrays, one fm_operator_scan
    # per operator per block at full width
    reset_all()
    p = build_fm_synth(VOICES, fused=False).compile(SR, block_size=1024,
                                                    device="cuda")
    poly_chord(p)
    un_blocks = [p.process_block()["audio_out"] for _ in range(3)]
    torch.cuda.synchronize()
    fm_launches["unfused fm synth"] = {
        "fm_operator_scan": kfm.launches["fm_operator_scan"]}
    un_audio = torch.cat(un_blocks).cpu().numpy()
    phase("main", f"unfused fm synth: 256 voices B=1024, 3 blocks, peak "
          f"{float(np.abs(un_audio).max()):.4f}, kernel launches "
          f"{fm_launches['unfused fm synth']} (3 operators x 3 blocks)")
    check(kfm.launches["fm_operator_scan"] == 9
          and np.isfinite(un_audio).all(),
          "unfused fm synth: fm_operator_scan did not run 9 times")
    for B in BLOCKS:
        p = build_fm_synth(VOICES, fused=False).compile(SR, block_size=B,
                                                        device="cuda")
        poly_chord(p)
        p.process_block()
        steady_busy("unfused fm synth", p.process_block, B)

    # the README synth (one voice: the kernels at V=1)
    readme = {}
    for device in ("cuda", "cpu"):
        readme[device] = build_simple_synth().compile(
            SR, block_size=512, device=device).render_mono(4800)
    out = readme["cuda"]
    spec = np.abs(np.fft.rfft(out[480:] * np.hanning(4320)))
    peak_hz = float(np.fft.rfftfreq(4320, 1 / SR)[spec.argmax()])
    err = float(np.abs(out - readme["cpu"]).max())
    phase("main", f"README synth: 4800 samples at B=512, peak {peak_hz:.1f} "
          f"Hz (440 +- 15), card against CPU {err:.3e} (<= "
          f"{POLY_TOL:.0e})")
    check(np.isfinite(out).all() and abs(peak_hz - 440.0) < 15.0
          and err <= POLY_TOL, "README synth checks failed")

    # the twin peaks: one plugin instance, audio arriving in every block
    from oscen_tpu_torch import Graph, IirLowpass, Oscillator
    from oscen_tpu_torch.models.twin_peaks import build_twin_peaks

    def twin_input(B, n):
        return (np.random.default_rng(1).standard_normal(n * B) * 0.3
                ).astype(np.float32)

    def twin_drive(device, fused, B, n=8):
        """Seeded noise staged block by block through ``audio_in``;
        cutoff_a 640 and resonance 0.8 at block 3, cutoff_b 2500 at block
        5 (tests/test_models_aux.py:187-199).  On the card every block
        after the first runs under sync debug mode "error": a block that
        waited for the card would fail the run."""
        x = twin_input(B, n)
        c = build_twin_peaks(fused=fused).compile(SR, block_size=B,
                                                  device=device)
        ys = []
        for i in range(n):
            if i == 3:
                c.set_value("cutoff_a", 640.0)
                c.set_value("resonance", 0.8)
            if i == 5:
                c.set_value("cutoff_b", 2500.0)
            with no_sync(device == "cuda" and i > 0):
                ys.append(c.process_block(
                    stream_inputs={"audio_in": x[i * B:(i + 1) * B]}
                )["audio_out"])
        return c, ys

    twin_launches = 0
    for B in BLOCKS:
        outs = {}
        for fused in (True, False):
            reset_all()
            t0 = time.perf_counter()
            c, ys = twin_drive("cuda", fused, B)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = kiir.launches["lp18_scan"]
            twin_launches += got
            want = (1 if fused else 2) * len(ys)
            audio = torch.cat(ys)
            leaves = []
            walk(c.state)
            peak = float(audio.abs().max())
            checks = {
                "shape": tuple(ys[0].shape) == (B,)
                and ys[0].device.type == "cuda",
                "finite": bool(torch.isfinite(audio).all()),
                "peak": 0.05 < peak < 10.0,
                "state_on_cuda": all(x.device.type == "cuda"
                                     for x in leaves),
                "lp18_launches": got == want,
            }
            label = "fused" if fused else "two-node"
            phase("main", f"twin peaks {label} B={B}: {len(ys)} blocks of "
                  f"seeded noise (blocks 2-8 under sync debug mode "
                  f"'error'), parameter changes at blocks 3 and 5, "
                  f"peak {peak:.4f}, {secs:.2f} s, lp18_scan launches "
                  f"{got} (want {want}); checks {checks}")
            check(all(checks.values()), f"twin peaks checks failed: "
                  f"{checks}")
            _, cpu = twin_drive("cpu", fused, B)
            errs = [float((a.cpu() - b).abs().max()) for a, b in zip(ys, cpu)]
            phase("main", f"twin peaks {label} B={B}: card against CPU, "
                  f"max abs per block {['%.3e' % e for e in errs]} (<= "
                  f"{TWIN_TOL:.0e})")
            check(max(errs) <= TWIN_TOL, "twin peaks: card and CPU disagree")
            outs[fused] = audio
        same = torch.equal(outs[True], outs[False])
        phase("main", f"twin peaks B={B}: fused equal to two-node "
              f"(torch.equal, {8 * B} samples) {'ok' if same else 'FAIL'}")
        check(same, "twin peaks: fused and two-node builds differ")

    # how often lp18_scan's tanh took its fallback on the twin peaks' own
    # input: every lp18_scan call of a fused B=1024 run, recorded on the way
    import oscen_tpu_torch.nodes.filters as nfilters
    calls = []

    def recording(x, g, h, z):
        calls.append((x, g, h, z))
        return kiir.lp18_scan(x, g, h, z)
    nfilters.lp18_scan = recording
    try:
        twin_drive("cuda", True, 1024)
    finally:
        nfilters.lp18_scan = kiir.lp18_scan
    shares = [tanh_fallback_share(torch, kiir, *c) for c in calls]
    undecided, samples, redone, chunks = (sum(s[i] for s in shares)
                                          for i in range(4))
    equal = all(s[4] for s in shares)
    phase("main", f"twin peaks fused B=1024: lp18_scan's tanh left "
          f"{undecided} of {samples} samples (2 lanes x {len(calls)} "
          f"blocks) to its fallback, in {redone} of {chunks} "
          f"{RING_CHUNK}-step chunks (each re-run whole by the reference "
          f"body); the short path equals the float64 tanh on all of them: "
          f"{equal}")
    check(len(calls) == 8 and samples == 2 * 8 * 1024, f"twin peaks: the "
          f"recorder saw {len(calls)} lp18_scan calls and {samples} "
          f"samples (want 8 and {2 * 8 * 1024})")
    check(equal, "twin peaks: tanh_exact differs from the float64 tanh on "
          "the filter's own input")

    # the IIR lowpass: saw -> IirLowpass -> out, a cutoff change mid-run
    def iir_drive(device, B, n):
        g = Graph("IirLowpassGraph")
        g.input("cutoff", "value", default=1000.0)
        g.output("out", "stream")
        o = g.add("o", Oscillator.saw(330.0, 0.5))
        f = g.add("f", IirLowpass(1000.0))
        g.connect("cutoff", f.cutoff)
        g.connect(o.output, f.input)
        g.connect(f.output, "out")
        c = g.compile(SR, block_size=B, device=device)
        ys = []
        for i in range(n):
            if i == n // 2:
                c.set_value("cutoff", 2500.0)
            with no_sync(device == "cuda" and i > 0):
                ys.append(c.process_block()["out"])
        return c, ys

    iir_launches = 0
    for B, n in ((1024, 8), (33, 64)):
        reset_all()
        c, ys = iir_drive("cuda", B, n)
        torch.cuda.synchronize()
        got = kiir.launches["biquad_scan"]
        iir_launches += got
        _, cpu = iir_drive("cpu", B, n)
        audio = torch.cat(ys).cpu()
        err = float((audio - torch.cat(cpu)).abs().max())
        peak = float(audio.abs().max())
        ok = (got == n and bool(torch.isfinite(audio).all())
              and 0.1 < peak < 2.0 and err <= TWIN_TOL
              and c.state["f"]["v1"].device.type == "cuda")
        phase("main", f"IIR lowpass B={B}: {n} blocks (all but the first "
              f"under sync debug mode 'error'), cutoff 1000 -> 2500 "
              f"Hz at block {n // 2}, peak {peak:.4f}, biquad_scan "
              f"launches {got} (want {n}), card against CPU {err:.3e} (<= "
              f"{TWIN_TOL:.0e}) {'ok' if ok else 'FAIL'}")
        check(ok, "IIR lowpass checks failed")
    for B in BLOCKS:
        c, _ = iir_drive("cuda", B, 1)
        steady_busy("IIR lowpass (saw -> IirLowpass)", c.process_block, B)

    # the oversampled saturator: a 2 kHz saw and a hard clip at 4x, the
    # sinc (build_saturator) or the IIR-halfband boundary
    from oscen_tpu_torch.models.simple import build_simple_echo

    def sat_drive(device, policy, B, n):
        c = sat_graph(policy).compile(SR, block_size=B, device=device)
        ys = []
        for i in range(n):
            with no_sync(device == "cuda" and i > 0):
                ys.append(c.process_block()["audio_out"])
        return c, ys

    def card_vs_cpu(label, ys, cpu):
        errs = [float((a.cpu() - b).abs().max()) for a, b in zip(ys, cpu)]
        phase("main", f"{label}: card against CPU, max abs per block "
              f"{['%.3e' % e for e in errs[:8]]}"
              + (f" ... (all {len(errs)} blocks: {max(errs):.3e})"
                 if len(errs) > 8 else "") + f" (<= {TWIN_TOL:.0e})")
        check(max(errs) <= TWIN_TOL, f"{label}: card and CPU disagree")

    sat_launches = {}
    for policy in ("sinc", "sinc_iir"):
        for B in BLOCKS:
            n = 8 if B == 1024 else 4
            reset_all()
            t0 = time.perf_counter()
            c, ys = sat_drive("cuda", policy, B, n)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            main_reruns[f"saturator 4x {policy} B={B}"] = kphase.take_reruns()
            got = {"phase_scan": kphase.launches["phase_scan"],
                   "allpass_cascade_scan":
                   kiir.launches["allpass_cascade_scan"]}
            for k, v in got.items():
                sat_launches[(policy, k)] = sat_launches.get(
                    (policy, k), 0) + v
            want = {"phase_scan": n,
                    "allpass_cascade_scan": 2 * n if policy == "sinc_iir"
                    else 0}
            audio = torch.cat(ys)
            leaves = []
            walk(c.state)
            peak = float(audio.abs().max())
            checks = {
                "shape": tuple(ys[0].shape) == (B,)
                and ys[0].device.type == "cuda",
                "finite": bool(torch.isfinite(audio).all()),
                "peak": 0.5 < peak < 1.2,
                "state_on_cuda": all(x.device.type == "cuda"
                                     for x in leaves),
                "launches": got == want,
            }
            label = f"saturator 4x {policy} B={B}"
            phase("main", f"{label}: {n} blocks (all but the first under "
                  f"sync debug mode 'error'), peak {peak:.4f}, {secs:.2f} s, "
                  f"kernel launches {got} (want {want}: one phase_scan over "
                  f"{4 * B} samples per block"
                  + (", one allpass_cascade_scan per halfband stage"
                     if policy == "sinc_iir" else "")
                  + f"); checks {checks}")
            check(all(checks.values()), f"{label} checks failed: {checks}")
            card_vs_cpu(label, ys[:4], sat_drive("cpu", policy, B, 4)[1])

    # the simple echo at its defaults: a 0.25 s delay whose feedback island
    # dissolves (min_delay 12000 >= B + 4)
    def echo_drive(device, B, n):
        """Seeded noise through ``x`` block by block; feedback 0.5 from
        block 0, mix 0.8 from block n // 2; every block after the first
        under sync debug mode "error" on the card."""
        x = echo_input(B, n)
        c = build_simple_echo().compile(SR, block_size=B, device=device)
        c.set_value("feedback", 0.5)
        ys = []
        for i in range(n):
            if i == n // 2:
                c.set_value("mix", 0.8)
            with no_sync(device == "cuda" and i > 0):
                ys.append(c.process_block(
                    stream_inputs={"x": x[i * B:(i + 1) * B]})["out"])
        return c, ys

    for B, n in ((1024, 48), (4096, 12)):
        reset_all()
        t0 = time.perf_counter()
        c, ys = echo_drive("cuda", B, n)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = kiir.launches["tpt_svf_scan"]
        audio = torch.cat(ys).cpu().numpy()
        # the dry part x * (1 - mix), as the graph computes it in float32
        keep = np.where(np.arange(n * B) < n // 2 * B,
                        np.float32(1.0) - np.float32(0.5),
                        np.float32(1.0) - np.float32(0.8)).astype(np.float32)
        wet = np.abs(audio - echo_input(B, n) * keep)
        D = 12000 + 1          # read 12000 samples back, before the push
        leaves = []
        walk(c.state)
        checks = {
            "shape": tuple(ys[0].shape) == (B,)
            and ys[0].device.type == "cuda",
            "finite": bool(np.isfinite(audio).all()),
            "dry_only_before_the_delay": float(wet[:D].max()) == 0.0,
            "echoes_return": all(float(wet[k * D:(k + 1) * D].max()) > 0.05
                                 for k in range(1, n * B // D)),
            "state_on_cuda": all(x.device.type == "cuda" for x in leaves),
            "dissolved": {"node": "delay", "path": "dissolved_island_delay"}
            in c.explain(),
            "tpt_svf_launches": got == n,
        }
        label = f"simple echo B={B}"
        phase("main", f"{label}: {n} blocks of seeded noise (all but the "
              f"first under sync debug mode 'error'), feedback 0.5, mix 0.8 "
              f"from block {n // 2}, peak {float(np.abs(audio).max()):.4f}, "
              f"{secs:.2f} s, tpt_svf_scan launches {got} (want {n}); "
              f"checks {checks}")
        check(all(checks.values()), f"{label} checks failed: {checks}")
        card_vs_cpu(label, ys, echo_drive("cpu", B, n)[1])

    # the README synth into the echo, block by block: each synth block goes
    # into the echo's x as the tensor it came back as, on the card
    def chain_drive(card_tensors, B=1024, n=16):
        synth = build_simple_synth().compile(SR, block_size=B, device="cuda")
        echo = build_simple_echo().compile(SR, block_size=B, device="cuda")
        echo.set_value("feedback", 0.5)
        ys = []
        for i in range(n):
            with no_sync(card_tensors and i > 0):
                x = synth.process_block()["out"]
                if not card_tensors:
                    x = x.cpu().numpy()
                ys.append(echo.process_block(stream_inputs={"x": x})["out"])
        return torch.cat(ys)
    reset_all()
    chained = chain_drive(True)
    got = kiir.launches["tpt_svf_scan"]
    got_ph = kphase.launches["phase_scan"]
    main_reruns["README synth"] = kphase.take_reruns()
    same = torch.equal(chained, chain_drive(False))
    phase("main", f"README synth -> simple echo B=1024: 16 blocks through "
          f"card tensors (blocks 2-16 under sync debug mode 'error'), "
          f"tpt_svf_scan launches {got} (want 32: the synth's filter and "
          f"the echo's), phase_scan launches {got_ph} (want 16: the "
          f"synth's saw), peak {float(chained.abs().max()):.4f}, equal to "
          f"the numpy-fed chain (torch.equal) {'ok' if same else 'FAIL'}")
    check(same and got == 32 and got_ph == 16,
          "synth -> echo chain checks failed")

    phase("main", "phase_scan's short wrap on each model's own input, "
          "(lane, chunk)s re-run with floor in its main-path run: "
          + "; ".join(f"{k} {n}" for k, n in main_reruns.items()))
    check(not any(main_reruns.values()),
          "phase_scan: the short wrap re-ran a chunk on a model's input")

    # ---- 4b. per_sample: sample mode and the scan islands ------------
    per_sample_launches = per_sample_phase(card)

    # ---- 4c. assets: convolution, the sampler, checkpoints -----------
    assets_phase(card)

    # ---- 4d. voice-capacity classes; the seven examples ---------------
    later_launches = [voice_classes_phase(card), examples_in_tmp(card)]

    # ---- 5. timing ---------------------------------------------------
    def time_ms(fn, reps, warm=2):
        """Wall time per call on the card's clock (CUDA events)."""
        for _ in range(warm):
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

    def device_ms(fn, reps, kernel=None, top=None):
        """Device time per call (``oscen_tpu_torch.tools.device_ms``, the
        profiler); a missing device time fails the run."""
        try:
            return tools.device_ms(fn, reps, kernel=kernel, top=top,
                                   note=lambda m: phase("timing", m))
        except RuntimeError as e:
            check(False, str(e))

    phase("timing", f"card {card}")
    # the SM clock under load (the chain floors below use it)
    sm_mhz = tools.sm_clock_mhz(dev)
    phase("timing", f"SM clock under load {sm_mhz:.0f} MHz (nvidia-smi)")

    def chain_floor_ms(key, B, segs=1):
        """``tools.chain_floor_us`` in ms (None: no serial chain)."""
        us = tools.chain_floor_us(key, B, sm_mhz, segs)
        return None if us is None else us / 1e3
    args = [planes[k] for k in ("osc_re", "osc_im", "mul_re", "mul_im",
                                "cur", "tgt", "mult")]
    def additive_kernel_name(version):
        return ("additive_parity_kernel" if version == "parity"
                else "additive_closed_kernel")

    for version in add.KERNELS:
        for B in BLOCKS:
            kf, pf = kernel_fn(version), plain_fn(version)
            ms = device_ms(lambda: kf(*args, step, B, True), 50,
                           kernel=additive_kernel_name(version))
            call_ms = time_ms(lambda: kf(*args, step, B, True), 50)
            plain_ms = time_ms(lambda: pf(*args, step, B, True),
                               3 if version == "parity" else 5)
            segs = add.segments(VOICES, B, add.subgroup_len(B, version))
            phase("timing", f"{version} V={VOICES} B={B} with_mix: kernel "
                  f"{ms * 1e3:.1f} us (device; {segs} time segments per "
                  f"voice, chain floor "
                  f"{chain_floor_ms(version, B, segs) * 1e3:.2f} us), "
                  f"wrapper call {call_ms * 1e3:.1f} us, plain PyTorch "
                  f"{plain_ms * 1e3:.1f} us/call ({card})")
            if B == 1024:
                report[version].update(
                    ms=ms, plain_ms=plain_ms,
                    **bound_of(version, args + [step],
                               kf(*args, step, B, True), B, H * VOICES))
    # K5: the v4 kernel with the tremolo pan after the mix
    for B in BLOCKS:
        tst, vals = trem_state(1000)
        C, fn, prm, _ = trem.kernel_epilogue(tst, vals, SampleRate(SR), B)

        def k5():
            return add.additive_voice_block(*args, step, B, with_mix=True,
                                            epi_fn=fn, epi_c=C,
                                            epi_params=prm)

        def k5_plain():
            out = add.plain_block(*args, step, B, True, "v4")
            return torch.stack(fn(out[0], 0, prm), dim=-1)
        ms = device_ms(k5, 50, kernel="additive_closed_kernel")
        call_ms = time_ms(k5, 50)
        plain_ms = time_ms(k5_plain, 5)
        phase("timing", f"v4_epilogue V={VOICES} B={B}: kernel "
              f"{ms * 1e3:.1f} us (device), wrapper call "
              f"{call_ms * 1e3:.1f} us, plain PyTorch "
              f"{plain_ms * 1e3:.1f} us/call ({card})")
        if B == 1024:
            report[add.EPILOGUE].update(
                ms=ms, plain_ms=plain_ms,
                **bound_of(add.EPILOGUE, args + [step, prm], k5(), B,
                           H * VOICES, extra_ops=PAN_OPS * B))
    for run in ("v4", "v3", "v2", add.EPILOGUE):
        piano_env(run)
        for B in BLOCKS:
            p = build_electric_piano(VOICES).compile(
                SR, block_size=B, mode="block", device="cuda")
            chord(p)
            p.process_block()
            ms = time_ms(lambda: p.process_block(), 20)
            busy, top, n_kern = device_ms(lambda: p.process_block(), 20,
                                          top=4)
            phase("timing", f"steady process_block ({run}) V={VOICES} "
                  f"B={B}: {ms * 1e3:.1f} us/block, device busy "
                  f"{busy * 1e3:.1f} us ({100 * busy / ms:.1f}%), "
                  f"{n_kern:.0f} device activities per block, real-time "
                  f"factor {(B / SR) / (ms * 1e-3):.1f}x ({card}); top: "
                  + "; ".join(f"{k[:50]} {t * 1e3:.1f} us x{c:.0f}"
                              for k, t, c in top))
    os.environ.pop("OSCEN_ADDITIVE_KERNEL", None)
    os.environ.pop("OSCEN_EPILOGUE_FUSION", None)

    # the scan kernels at the poly synth's shapes (V=256 voices)
    cuda_name = {"phase_scan": "phase_ring_kernel",
                 "tpt_svf_scan": "tpt_svf_kernel",
                 "adsr_scan": "adsr_kernel"}
    plain_reps = {"phase_scan": 3, "tpt_svf_scan": 2, "adsr_scan": 1}
    for name, mod in scans.items():
        fn, plain = getattr(mod, name), getattr(mod, "plain_" + name)
        for B in BLOCKS:
            if name == "phase_scan":
                args = (rand(0, 1, (VOICES,)), rand(0, 0.3, (B, VOICES)))
            elif name == "tpt_svf_scan":
                args = (rand(-1, 1, (B, VOICES)), rand(0.3, 0.9, (VOICES,)),
                        rand(0.05, 0.5, (VOICES,)), rand(1, 2, (VOICES,)),
                        rand(-1, 1, (VOICES,)), rand(-1, 1, (VOICES,)))
            else:
                st, rows, sus = adsr_inputs(VOICES)
                args = (st, *rows, sus[None].expand(B, VOICES).contiguous())
            ms = device_ms(lambda: fn(*args), 50, kernel=cuda_name[name])
            plain_ms = time_ms(lambda: plain(*args), plain_reps[name],
                               warm=1)
            phase("timing", f"{name} V={VOICES} B={B}: kernel "
                  f"{ms * 1e3:.1f} us (device), chain floor "
                  f"{chain_floor_ms(name, B) * 1e3:.1f} us, plain PyTorch "
                  f"{plain_ms * 1e3:.1f} us/call ({card})")
            if B == 1024:
                report[name].update(ms=ms, plain_ms=plain_ms,
                                    **bound_of(name, args, fn(*args), B,
                                               VOICES))
    # phase_scan at the 4x saturator's shape: one lane over 4B steps
    for B in (4096, 16384):
        args = (rand(0, 1, (1,)), rand(0.001, 0.5, (B, 1)))
        ms = device_ms(lambda: kphase.phase_scan(*args), 50,
                       kernel=cuda_name["phase_scan"])
        b = bound_of("phase_scan", args, kphase.phase_scan(*args), B, 1)
        phase("timing", f"phase_scan V=1 B={B} (the 4x saturator's lane): "
              f"kernel {ms * 1e3:.1f} us (device), bound "
              f"{b['bound_ms'] * 1e3:.4f} us ({b['bound_by']}), chain floor "
              f"{chain_floor_ms('phase_scan', B) * 1e3:.1f} us ({card})")

    # the steady poly-synth block, and where its device time goes
    for B in BLOCKS:
        p = build_poly_synth(VOICES).compile(SR, block_size=B,
                                             device="cuda")
        poly_chord(p)
        p.process_block()
        ms = time_ms(lambda: p.process_block(), 20)
        busy, top, n_kern = device_ms(lambda: p.process_block(), 20,
                                      top=6)
        phase("timing", f"poly synth steady process_block V={VOICES} "
              f"B={B}: {ms * 1e3:.1f} us/block, device busy "
              f"{busy * 1e3:.1f} us ({100 * busy / ms:.1f}%), "
              f"{n_kern:.0f} device activities per block, real-time "
              f"factor {(B / SR) / (ms * 1e-3):.1f}x ({card})")
        phase("timing", f"poly synth B={B} top device time per block: "
              + "; ".join(f"{k[:60]} {t * 1e3:.1f} us x{c:.0f}"
                          for k, t, c in top))

    # host time per node in a steady block: each node's block methods
    # wrapped in a profiler range (wrapped before the first block, so the
    # block compiler reads the same signatures)
    import functools

    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(fn, label):
        @functools.wraps(fn)
        def inner(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return inner

    def host_time_by_node(label, build):
        p = build(VOICES).compile(SR, block_size=1024, device="cuda")
        for nm, inst in p.ir.nodes.items():
            for meth in ("process_block", "process_block_batched"):
                if hasattr(inst.node, meth) and not inst.node.HOST:
                    setattr(inst.node, meth,
                            ranged(getattr(inst.node, meth), f"node:{nm}"))
        poly_chord(p)
        for _ in range(3):
            p.process_block()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(20):
                p.process_block()
            torch.cuda.synchronize()
        host = {e.key: e.cpu_time_total / 20 / 1e3
                for e in prof.key_averages() if e.key.startswith("node:")}
        phase("timing", f"{label} B=1024 host time per steady block by node "
              "(profiler ranges): " + ", ".join(
                  f"{k[5:]} {v * 1e3:.0f} us" for k, v in sorted(
                      host.items(), key=lambda kv: -kv[1])))


    # the FM kernels at the fm synth's and pivot's shapes (V=256 voices)
    fm_cuda_name = {"fract_phase3": "fract_phase3_kernel",
                    "fm_chain3_scan": "chain3_kernel",
                    "pivot_chain3_scan": "chain3_kernel",
                    "fm_operator_scan": "fm_operator_kernel"}
    for name in kfm.KERNELS:
        fn, plain = getattr(kfm, name), getattr(kfm, "plain_" + name)
        for B in BLOCKS:
            # the chains also with per-sample dt (a note-on block)
            for per_sample in ((False, True) if "chain" in name
                               else (False,)):
                rng_f = np.random.default_rng(B)
                args = fm_carry(name, VOICES, rng_f) + fm_args(
                    name, VOICES, B, rng_f, per_sample)
                if name == "fract_phase3":   # the models' phases and dt
                    args = fract_inputs("on", VOICES, rng_f) + (B,)
                ms = device_ms(lambda: fn(*args), 50,
                               kernel=fm_cuda_name[name])
                plain_ms = time_ms(lambda: plain(*args), 1, warm=1)
                what = ((" (per-sample dt, feedback)" if per_sample else
                         " (block-constant dt, feedback)")
                        if "chain" in name else " (on lanes)"
                        if name == "fract_phase3" else "")
                phase("timing", f"{name} V={VOICES} B={B}{what}: kernel "
                      f"{ms * 1e3:.1f} us (device), plain PyTorch "
                      f"{plain_ms * 1e3:.1f} us/call ({card})")
                if B == 1024 and not per_sample:
                    report[name].update(ms=ms, plain_ms=plain_ms,
                                        **bound_of(name, args, fn(*args), B,
                                                   VOICES))

    # K12 on lanes off its short wrap, and on warps whose lanes disagree
    # (they run both loops)
    for lanes in FRACT_LANES[1:]:
        for B in BLOCKS:
            p, dt = fract_inputs(lanes, VOICES, np.random.default_rng(B))
            ms = device_ms(lambda: kfm.fract_phase3(p, dt, B), 50,
                           kernel=fm_cuda_name["fract_phase3"])
            phase("timing", f"fract_phase3 V={VOICES} B={B} ({lanes} "
                  f"lanes): kernel {ms * 1e3:.1f} us (device), chain floor "
                  f"{chain_floor_ms('fract_phase3', B) * 1e3:.1f} us "
                  f"({card})")

    # the steady fm-synth and pivot blocks, and where their device time
    # goes (the pivot also with op3_feedback 0.3: pivot_chain3_scan)
    for label, build, fb in (("fm synth", build_fm_synth, None),
                             ("pivot", build_pivot, None),
                             ("pivot op3_feedback=0.3", build_pivot, 0.3)):
        for B in BLOCKS:
            p = build(VOICES).compile(SR, block_size=B, device="cuda")
            poly_chord(p)
            if fb is not None:
                p.set_value("op3_feedback", fb)
            p.process_block()
            ms = time_ms(lambda: p.process_block(), 20)
            busy, top, n_kern = device_ms(lambda: p.process_block(), 20,
                                          top=6)
            phase("timing", f"{label} steady process_block V={VOICES} "
                  f"B={B}: {ms * 1e3:.1f} us/block, device busy "
                  f"{busy * 1e3:.1f} us ({100 * busy / ms:.1f}%), "
                  f"{n_kern:.0f} device activities per block, real-time "
                  f"factor {(B / SR) / (ms * 1e-3):.1f}x ({card})")
            phase("timing", f"{label} B={B} top device time per block: "
                  + "; ".join(f"{k[:60]} {t * 1e3:.1f} us x{c:.0f}"
                              for k, t, c in top))

    # the filter kernels at the main path's shapes: lp18_scan at V=2 (the
    # fused twin peaks) and V=1 (two-node), biquad_scan at V=1 with
    # per-sample planes (the IIR lowpass's latched coefficients)
    for name, V in (("lp18_scan", 2), ("lp18_scan", 1), ("biquad_scan", 1)):
        fn, plain = getattr(kiir, name), getattr(kiir, "plain_" + name)
        for B in BLOCKS:
            rng_f = np.random.default_rng(B + V)
            x = on_card((0.3 * rng_f.standard_normal((B, V))).astype(
                np.float32))
            if name == "lp18_scan":
                args = (x, rand(0.05, 0.2, (V,)), rand(1.0, 1.6, (V,)),
                        rand(-0.1, 0.1, (3, V)))
            else:
                args = (x, *biquad_rows(rng_f, (B, V)),
                        torch.zeros(V, device=dev), torch.zeros(V, device=dev))
            kname = name.split("_")[0] + "_kernel"
            ms = device_ms(lambda: fn(*args), 50, kernel=kname)
            plain_ms = time_ms(lambda: plain(*args), 1, warm=1)
            b = bound_of(name, args, fn(*args), B, V)
            phase("timing", f"{name} V={V} B={B}: kernel {ms * 1e3:.1f} us "
                  f"(device), bound {b['bound_ms'] * 1e3:.3f} us "
                  f"({b['bound_by']}), chain floor "
                  f"{chain_floor_ms(name, B) * 1e3:.1f} us, plain PyTorch "
                  f"{plain_ms * 1e3:.1f} us/call ({card})")
            if B == 1024 and V == (2 if name == "lp18_scan" else 1):
                report[name].update(ms=ms, plain_ms=plain_ms, **b)

    # K9 at the IIR lowpass's lane and at 256 lanes with rows and with
    # planes, and K14 at the unfused fm voice's 256 voices, by CUDA events
    # behind a sleep (tools.event_us: no profiler session)
    for label, V, planes in (("V=1 per-sample planes", 1, True),
                             (f"V={VOICES} rows", VOICES, False),
                             (f"V={VOICES} per-sample planes", VOICES, True)):
        for B in BLOCKS:
            rng_f = np.random.default_rng(3 * B + V)
            args = (on_card((0.3 * rng_f.standard_normal((B, V))).astype(
                np.float32)), *biquad_rows(rng_f, (B, V) if planes else (V,)),
                rand(-1, 1, (V,)), rand(-1, 1, (V,)))
            us = tools.event_us(lambda: kiir.biquad_scan(*args), 20)
            phase("timing", f"biquad_scan {label} B={B}: kernel {us:.1f} us "
                  f"(events), {us * sm_mhz / B:.1f} cycles a step, chain "
                  f"floor {chain_floor_ms('biquad_scan', B) * 1e3:.1f} us "
                  f"({card})")
    for B in BLOCKS:
        rng_f = np.random.default_rng(5 * B)
        args = fm_carry("fm_operator_scan", VOICES, rng_f) + fm_args(
            "fm_operator_scan", VOICES, B, rng_f)
        us = tools.event_us(lambda: kfm.fm_operator_scan(*args), 20)
        phase("timing", f"fm_operator_scan V={VOICES} B={B}: kernel "
              f"{us:.1f} us (events), {us * sm_mhz / B:.1f} cycles a step, "
              f"chain floor {chain_floor_ms('fm_operator_scan', B) * 1e3:.1f}"
              f" us ({card})")

    # the twin peaks' streaming block: the host stages audio_in, then one
    # (fused) or two lp18_scan launches
    for fused in (True, False):
        label = "fused" if fused else "two-node"
        for B in BLOCKS:
            tp = build_twin_peaks(fused=fused).compile(SR, block_size=B,
                                                       device="cuda")
            xb = {"audio_in": twin_input(B, 1)}
            tp.process_block(stream_inputs=xb)
            ms = time_ms(lambda: tp.process_block(stream_inputs=xb), 20)
            busy, top, n_kern = device_ms(
                lambda: tp.process_block(stream_inputs=xb), 20, top=6)
            phase("timing", f"twin peaks {label} process_block B={B} (audio "
                  f"staged from the host): {ms * 1e3:.1f} us/block, device "
                  f"busy {busy * 1e3:.1f} us ({100 * busy / ms:.1f}%), "
                  f"{n_kern:.0f} device activities per block, real-time "
                  f"factor {(B / SR) / (ms * 1e-3):.1f}x ({card})")
            phase("timing", f"twin peaks {label} B={B} top device time per "
                  f"block: " + "; ".join(f"{k[:60]} {t * 1e3:.1f} us x{c:.0f}"
                                         for k, t, c in top))

    # the allpass cascade at the IIR saturator's shapes: V=2 lanes (the two
    # branches of a halfband stage) over 2B then B samples per block at 4x
    # (and over 2 then 1 samples: sample mode runs the down resampler once
    # per outer sample)
    for V, Bp in ((2, 2048), (2, 1024), (2, 8192), (2, 4096), (2, 2),
                  (2, 1)):
        args = allpass_operands(V, Bp, np.random.default_rng(Bp))
        fn = kiir.allpass_cascade_scan
        ms = device_ms(lambda: fn(*args), 50, kernel="allpass_kernel")
        plain_ms = time_ms(lambda: kiir.plain_allpass_cascade_scan(*args), 1,
                           warm=1)
        b = bound_of("allpass_cascade_scan", args, fn(*args), Bp, V)
        phase("timing", f"allpass_cascade_scan V={V} B={Bp}: kernel "
              f"{ms * 1e3:.1f} us (device), bound {b['bound_ms'] * 1e3:.3f} "
              f"us ({b['bound_by']}), plain PyTorch {plain_ms * 1e3:.1f} "
              f"us/call ({card})")
        if Bp == 2048:
            report["allpass_cascade_scan"].update(ms=ms, plain_ms=plain_ms,
                                                  **b)

    # the saturators' and the echo's steady blocks (the echo's input staged
    # from the host every block), and where their device time goes
    for label, make in (
            ("saturator 4x sinc", lambda B: sat_graph("sinc")),
            ("saturator 4x sinc_iir", lambda B: sat_graph("sinc_iir")),
            ("simple echo", lambda B: build_simple_echo())):
        for B in BLOCKS:
            c = make(B).compile(SR, block_size=B, device="cuda")
            kw = ({"stream_inputs": {"x": echo_input(B, 1)}}
                  if label == "simple echo" else {})
            c.process_block(**kw)
            ms = time_ms(lambda: c.process_block(**kw), 20)
            busy, top, n_kern = device_ms(lambda: c.process_block(**kw), 20,
                                          top=6)
            phase("timing", f"{label} process_block B={B}: "
                  f"{ms * 1e3:.1f} us/block, device busy {busy * 1e3:.1f} us "
                  f"({100 * busy / ms:.1f}%), {n_kern:.0f} device activities "
                  f"per block, real-time factor {(B / SR) / (ms * 1e-3):.1f}x "
                  f"({card})")
            phase("timing", f"{label} B={B} top device time per block: "
                  + "; ".join(f"{k[:60]} {t * 1e3:.1f} us x{c_:.0f}"
                              for k, t, c_ in top))

    # ---- 6. ablations of K1 and K12 (K16, K17) -----------------------
    ablations(torch, dev, card, report, device_ms, time_ms)

    # host time by node last: a CPU-only profiler session before a device
    # one left the device one empty once (H100, torch 2.11)
    host_time_by_node("poly synth", build_poly_synth)
    host_time_by_node("fm synth", build_fm_synth)
    host_time_by_node("pivot", build_pivot)

    sources = {"v4": ("additive_voice_v4", "additive.cu",
                      "oscen_tpu/ops/pallas/additive.py:260"),
               "parity": ("additive_voice_parity", "additive.cu",
                          "oscen_tpu/ops/pallas/additive.py:401"),
               "v3": ("additive_voice_v3", "additive.cu",
                      "oscen_tpu/ops/pallas/additive.py:173"),
               "v2": ("additive_voice_v2", "additive.cu",
                      "oscen_tpu/ops/pallas/additive.py:85"),
               add.EPILOGUE: ("additive_voice_v4_tremolo_epilogue",
                              "additive.cu",
                              "oscen_tpu/ops/pallas/additive.py:287"),
               "phase_scan": ("phase_scan", "phase.cu",
                              "oscen_tpu/ops/pallas/phase.py:53"),
               "tpt_svf_scan": ("tpt_svf_scan", "iir.cu",
                                "oscen_tpu/ops/pallas/iir.py:103"),
               "adsr_scan": ("adsr_scan", "adsr.cu",
                             "oscen_tpu/ops/pallas/adsr.py:122"),
               "fract_phase3": ("fract_phase3", "fm.cu",
                                "oscen_tpu/ops/pallas/fm.py:199"),
               "fm_chain3_scan": ("fm_chain3_scan", "fm.cu",
                                  "oscen_tpu/ops/pallas/fm.py:325"),
               "fm_operator_scan": ("fm_operator_scan", "fm.cu",
                                    "oscen_tpu/ops/pallas/fm.py:361"),
               "pivot_chain3_scan": ("pivot_chain3_scan", "fm.cu",
                                     "oscen_tpu/ops/pallas/fm.py:517"),
               "lp18_scan": ("lp18_scan", "iir.cu",
                             "oscen_tpu/ops/pallas/iir.py:185"),
               "biquad_scan": ("biquad_scan", "iir.cu",
                               "oscen_tpu/ops/pallas/iir.py:262"),
               "allpass_cascade_scan": ("allpass_cascade_scan", "iir.cu",
                                        "oscen_tpu/ops/pallas/iir.py:328")}
    # main-path launches: the piano (each version's run, and the fused
    # epilogue's), the poly synth, the FM models
    # (fract_phase3 from the fm synth's and the pivot's runs together), the
    # twin peaks (fused and two-node, both block sizes), the IIR lowpass and
    # the IIR-boundary saturator (both block sizes, and sample mode's run)
    path_launches = {k: launches[k][k] for k in RUNS}
    path_launches.update(poly_launches)
    path_launches["fract_phase3"] = sum(
        fm_launches[m]["fract_phase3"] for m in ("fm synth", "pivot"))
    path_launches["fm_chain3_scan"] = fm_launches["fm synth"][
        "fm_chain3_scan"]
    path_launches["pivot_chain3_scan"] = fm_launches["pivot"][
        "pivot_chain3_scan"]
    path_launches["fm_operator_scan"] = fm_launches["unfused fm synth"][
        "fm_operator_scan"]
    path_launches["lp18_scan"] = twin_launches
    path_launches["biquad_scan"] = iir_launches
    # K10: the IIR-boundary saturator in block mode and in sample mode
    path_launches["allpass_cascade_scan"] = sat_launches[
        ("sinc_iir", "allpass_cascade_scan")] + per_sample_launches[
        "allpass_cascade_scan"]
    # the class host's and the examples' paths
    for got in later_launches:
        for k, n in got.items():
            if k in path_launches:
                path_launches[k] += n
    # the ablation kernels are on no model's main path
    path_launches.update({k: 0 for k in ABLATION_KERNELS})
    sources.update(ABLATION_KERNELS)
    kernels = []
    for key, rep in report.items():
        name, src, replaces = sources[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"oscen_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": path_launches[key],
            "max_abs_err": rep["max_abs_err"],
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            # the timed calls ran B=1024 (the allpass cascade's first 4x
            # stage 2048); an additive voice runs in time segments
            "chain_floor_ms": chain_floor_ms(
                key, 2048 if key == "allpass_cascade_scan" else 1024,
                add.segments(VOICES, 1024, add.subgroup_len(1024, key))
                if key in add.KERNELS + (add.EPILOGUE,) else 1),
            # no single PyTorch call computes these per-sample recurrences
            # (no lfilter in torch; cumsum is not a wrapped phase)
            "library_ms": None})
    phase("total", "seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()) + f"; all "
        f"{time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase_only(libs, run) -> int:
    """One phase alone: the build of the kernels it launches (``libs``,
    in parallel), then ``run(card)``; no result lines."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from concurrent.futures import ThreadPoolExecutor
    from oscen_tpu_torch.ops.cuda import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(build.load_library, libs))
    phase("build", ", ".join(f"{n}.cu" for n in libs) + " built")
    run(f"{torch.cuda.get_device_name(0)} ({smi})")
    phase("total", "seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()))
    return 0


def examples_in_tmp(card):
    import tempfile
    return examples_phase(card, tempfile.mkdtemp(prefix="oscen_examples_"))


# ``python3 chip_smoke.py <phase>``: that phase alone, after building the
# kernels it launches
ONLY = {"per_sample": (("additive", "phase", "iir"), per_sample_phase),
        "assets": (("additive", "iir"), assets_phase),
        "voice_classes": (("additive",), voice_classes_phase),
        "examples": (("additive", "phase", "iir", "fm"), examples_in_tmp)}


if __name__ == "__main__":
    sys.exit(phase_only(*ONLY[sys.argv[1]]) if sys.argv[1:2]
             and sys.argv[1] in ONLY else main())
