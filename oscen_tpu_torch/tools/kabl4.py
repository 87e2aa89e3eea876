"""Attribution of the v3 additive body at the production config.

Counterpart of the JAX package's ``tools/kabl4.py``, on the card (kernel A,
``csrc/kabl.cu``):

  v3b      : the v3 body (f32, 2-FMA amp, row recurrence, SUB=32)
  norows   : constant rows 0.9-0.001j, 0.001j (prices the row recurrence)
  noamp    : amp = tgt (prices the amp FMAs)
  noim     : im = zr (prices the rotation)
  nored    : harmonic 0's product (prices the harmonic sum)
  noout    : no y store, every sum kept alive (prices the mix and store)
  defmix   : per-tick products to shared memory, one block-level tree per
             body of 64 ticks instead of the per-tick warp sum
  defmix64 : defmix at SUB=64

All at H=32 harmonics, V=256 voices, B=1024, float32. Parity and timing:
see ``oscen_tpu_torch.tools`` (the TPU tool's span differences become the
profiler's device time and CUDA events over a chain of launches with the
state fed back).

Usage: python -m oscen_tpu_torch.tools.kabl4 [variants...] [--device cpu]
"""

from __future__ import annotations

import sys

from . import kabl_main, uniform_inputs


def inputs(B: int = 1024):
    """The planes of ``tools/kabl4.py`` (``kabl4.py:209-223``): 55 Hz
    harmonic rotations, a unit oscillator, envelopes at ``cur * 0.999``,
    steps 0-63."""
    return uniform_inputs()[0]


def main(argv=None) -> int:
    return kabl_main("kabl4", argv, __doc__, inputs)


if __name__ == "__main__":
    sys.exit(main())
