"""The harmonic-major form of the additive body.

Counterpart of the JAX package's ``tools/kabl5.py``, on the card (kernel A
for ``v3b``, kernel C ``csrc/kabl_hmaj.cu`` for the rest):

  v3b     : the v3 body (tick-major)
  hmaj_cp : harmonic-major, rows by a segmented cumprod, rotation tables
            read from device memory
  hmaj_x  : the same, rows read from [B, V] inputs (prices the cumprod)
  hmaj_t2 : hmaj_cp with two voice tiles, each its own mix columns

All at H=32 harmonics, V=256 voices, B=1024, float32; y of the h-major
forms is [B, 128 x tiles]. Parity and timing: see ``oscen_tpu_torch.tools``
(the TPU tool's span differences become the profiler's device time and CUDA
events over a chain of launches with the state fed back).

Usage: python -m oscen_tpu_torch.tools.kabl5 [variants...] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from . import kabl_main, uniform_inputs
from ..ops.cuda.kabl import hmaj_tables, ref_rows


def inputs(B: int = 1024):
    """The planes of ``tools/kabl5.py`` (``kabl5.py:292-319``): 55 Hz
    harmonic rotations, a unit oscillator, envelopes at ``cur * 0.999``,
    steps 0-63."""
    x, th = uniform_inputs()
    x.update(hmaj_tables(th))
    x["r1"], x["r2"] = ref_rows(np.ones_like(x["step"]), x["step"], B)
    return x


def main(argv=None) -> int:
    return kabl_main("kabl5", argv, __doc__, inputs)


if __name__ == "__main__":
    sys.exit(main())
