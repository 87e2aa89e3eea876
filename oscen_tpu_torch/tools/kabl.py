"""Cost attribution of the v3 additive body: one cost removed at a time.

Counterpart of the JAX package's ``tools/kabl.py``, on the card (kernel A,
``csrc/kabl.cu``):

  full      : the v3 body (rows by the per-tick recurrence, 2-FMA amp)
  no_amp    : amp = tgt (prices the amp FMAs)
  no_rows   : rows p*0.5, p*0.25, the step never advances (prices the rows)
  no_env    : no amp at all (prices the envelope)
  no_reduce : harmonic 0's product only (prices the harmonic sum)

All at H=32 harmonics, V=256 voices, B=1024, float32. Parity and timing:
see ``oscen_tpu_torch.tools`` (the TPU tool's span differences become the
profiler's device time and CUDA events over a chain of launches with the
state fed back).

Usage: python -m oscen_tpu_torch.tools.kabl [variants...] [--device cpu]
"""

from __future__ import annotations

import sys

from . import kabl_main, uniform_inputs


def inputs(B: int = 1024):
    """The planes of ``tools/kabl.py`` (``kabl.py:147-157``): 55 Hz harmonic
    rotations, a unit oscillator, envelopes at ``cur * 0.999``, steps
    0-63."""
    return uniform_inputs()[0]


def main(argv=None) -> int:
    return kabl_main("kabl", argv, __doc__, inputs)


if __name__ == "__main__":
    sys.exit(main())
