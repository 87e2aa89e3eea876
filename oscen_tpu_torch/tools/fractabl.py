"""Packed-plane ablation of fract_phase3 (K12) on the card.

Counterpart of the JAX package's ``tools/fractabl.py``:

  cur    : fract_phase3 as the FM models run it (``ops/cuda/fm.py``, K12)
  packed : the tool's [6, 128] sublane packing; on the card two voices per
           thread with float2 loads and stores (``csrc/fractabl.cu``)

Both at B=1024, V=256.  The parity line holds packed ``torch.equal`` to
cur (every output).  Timing: see ``oscen_tpu_torch.tools``; the TPU tool's
host spans of a jitted scan become the profiler's device time and CUDA
events around a chain of launches with the carry fed back.

Usage: python -m oscen_tpu_torch.tools.fractabl [cur|packed ...] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import chain_us, device_us, parse_args, report, round_robin
from ..ops.cuda import fm, fractabl

B, V, SR = 1024, 256, 48_000.0
VARIANTS = ("cur", "packed")
KERNEL = {"cur": "fract_phase3_kernel", "packed": "fract_abl_kernel"}


def inputs(device, seed=0):
    """Phases uniform in [0, 1), dt at 440 Hz (``fractabl.py:35-37``)."""
    rng = np.random.default_rng(seed)
    phases = rng.uniform(0, 1, (3, V)).astype(np.float32)
    dt = np.full((3, V), 440.0 / SR, np.float32)
    return (torch.as_tensor(phases, device=device),
            torch.as_tensor(dt, device=device))


def run(variant, phases, dt, n=B):
    if variant == "cur":
        return fm.fract_phase3(phases, dt, n)
    return fractabl.fract_layout("packed", phases, dt, n)


def main(argv=None) -> int:
    args = parse_args(argv, VARIANTS, __doc__)
    phases, dt = inputs(args.device)
    ref = run("cur", phases, dt)
    for v in args.variants:
        out = run(v, phases, dt)
        same = all(torch.equal(a, b) for a, b in zip(out, ref))
        print(f"[fractabl] parity {v}: equal to fract_phase3 "
              f"(torch.equal, every output) {same}", flush=True)
        if not same:
            return 1
    if args.device == "cpu":
        print("[fractabl] timing needs a CUDA card")
        return 0

    def measure(v):
        return (device_us(lambda: run(v, phases, dt), KERNEL[v]),
                chain_us(lambda c: run(v, c, dt)[3], phases))
    report(round_robin(args.variants, measure), "cur")
    return 0


if __name__ == "__main__":
    sys.exit(main())
