"""Row delivery in the v3 additive body.

Counterpart of the JAX package's ``tools/kabl2.py``, on the card (kernel A,
and kernel B for the one-hot products, ``csrc/kabl.cu``):

  base   : constant rows p*0.5, p*0.25 (the rows' floor)
  recur  : the per-tick row recurrence
  loads  : rows read per tick from a zero-filled shared-memory table
  dot32  : base rows + a discarded one-hot mma.sync product per subgroup
  dot4   : base rows + 4 discarded whole-block one-hot products
  v4     : rows from a one-hot product per subgroup (shared memory)
  v5     : rows from 4 whole-block one-hot products (shared memory)
The one-hot table is the tool's ``[4B, 72]`` bf16 zeros.

All at H=32 harmonics, V=256 voices, B=1024, float32. Parity and timing:
see ``oscen_tpu_torch.tools`` (the TPU tool's span differences become the
profiler's device time and CUDA events over a chain of launches with the
state fed back).

Usage: python -m oscen_tpu_torch.tools.kabl2 [variants...] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from . import kabl_main, uniform_inputs


def inputs(B: int = 1024):
    """The planes of ``tools/kabl2.py`` (``kabl2.py:204-214``): 55 Hz
    harmonic rotations, a unit oscillator, envelopes at ``cur * 0.999``,
    steps 0-63."""
    x = uniform_inputs()[0]
    x["tbl"] = np.zeros((4 * B, 72), np.float32)
    return x


def main(argv=None) -> int:
    return kabl_main("kabl2", argv, __doc__, inputs)


if __name__ == "__main__":
    sys.exit(main())
