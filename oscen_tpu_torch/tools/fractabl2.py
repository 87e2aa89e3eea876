"""fract_phase3 (K12) store layouts measured end to end through the
zero-feedback FM consumer, on the card.

Counterpart of the JAX package's ``tools/fractabl2.py``:

  cur    : fract_phase3 as the FM models run it (``ops/cuda/fm.py``, K12)
  direct : one store of the whole [3, V] plane per step into [B, 3, V];
           the consumer reads strided views o[:, k]
  seg    : S=8 segment boundaries swept first, then the segments replayed
           in parallel into a j-major [SEG, 3S, V] output that the
           consumer reads through an un-permuting view

The consumer (``fractabl.consume``: ``sin_turns`` of the three phases with
the route mix and the envelopes) stays plain PyTorch.  The parity line
holds every layout ``torch.equal`` to cur.  Timing: device µs of the
layout's kernel (profiler), and wall µs per block of kernel + consumer
(CUDA events over a chain with the carry fed back); see
``oscen_tpu_torch.tools``.

Usage:
    python -m oscen_tpu_torch.tools.fractabl2 [cur|direct|seg ...] \
        [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import chain_us, device_us, parse_args, report, round_robin
from ..ops.cuda import fm, fractabl

B, V, SR = 1024, 256, 48_000.0
VARIANTS = ("cur", "direct", "seg")
KERNEL = {"cur": "fract_phase3_kernel", "direct": "fract_abl_kernel",
          "seg": "fract_abl_kernel"}


def inputs(device, seed=0):
    """``fractabl2.py:38-46``: uniform phases, per-operator dt up to 0.02,
    an envelope stream e3 and its rolls e2, e1, a route mix per voice."""
    rng = np.random.default_rng(seed)
    phases = rng.uniform(0, 1, (3, V)).astype(np.float32)
    dt = np.broadcast_to(rng.uniform(0, 1, (3, 1)).astype(np.float32)
                         * np.float32(0.02), (3, V)).copy()
    e3 = rng.uniform(0, 1, (B, V)).astype(np.float32)
    mix = rng.uniform(0, 1, (V,)).astype(np.float32)
    t = {k: torch.as_tensor(x, device=device) for k, x in dict(
        phases=phases, dt=dt, e3=e3, e2=np.roll(e3, 1, 0),
        e1=np.roll(e3, 2, 0), mix=mix).items()}
    return t


def run(variant, phases, dt, n=B):
    if variant == "cur":
        return fm.fract_phase3(phases, dt, n)
    return fractabl.fract_layout(variant, phases, dt, n)


def block(variant, phases, x):
    """One block: the layout's phases, then the consumer; returns
    (carry, output)."""
    o3, o2, o1, c = run(variant, phases, x["dt"])
    return c, fractabl.consume(o3, o2, o1, x["e3"], x["e2"], x["e1"],
                               x["mix"])


def main(argv=None) -> int:
    args = parse_args(argv, VARIANTS, __doc__)
    x = inputs(args.device)
    ref = run("cur", x["phases"], x["dt"])
    ref_y = block("cur", x["phases"], x)[1]
    for v in args.variants:
        out = run(v, x["phases"], x["dt"])
        same = all(torch.equal(a, b) for a, b in zip(out, ref)) \
            and torch.equal(block(v, x["phases"], x)[1], ref_y)
        print(f"[fractabl2] parity {v}: equal to fract_phase3 (torch.equal, "
              f"every output and the consumer's) {same}", flush=True)
        if not same:
            return 1
    if args.device == "cpu":
        print("[fractabl2] timing needs a CUDA card")
        return 0

    def measure(v):
        return (device_us(lambda: run(v, x["phases"], x["dt"]), KERNEL[v]),
                chain_us(lambda c: block(v, c, x)[0], x["phases"]))
    report(round_robin(args.variants, measure), "cur",
           labels=("kernel", "block+consumer"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
