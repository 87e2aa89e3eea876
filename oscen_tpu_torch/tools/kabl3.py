"""Precision and subgroup length of the v3 additive body.

Counterpart of the JAX package's ``tools/kabl3.py``, on the card (kernel A,
and kernel B for ``bf16_mxu``, ``csrc/kabl.cu``):

  v3b      : the v3 body (f32, SUB=32)
  v3b64    : SUB=64
  bf16_vpu : bf16 rotation, amp and product (__hmul / __hadd), f32 sum
  bf16_mxu : the bf16 products summed by a block-diagonal ones matrix on
             the tensor cores (mma.sync, f32 accumulation)

All at H=32 harmonics, V=256 voices, B=1024, float32; bf16 where the tool
rounds to bf16. Parity and timing: see ``oscen_tpu_torch.tools`` (the TPU
tool's span differences become the profiler's device time and CUDA events
over a chain of launches with the state fed back).

Usage: python -m oscen_tpu_torch.tools.kabl3 [variants...] [--device cpu]
"""

from __future__ import annotations

import sys

from . import kabl_main, uniform_inputs


def inputs(B: int = 1024):
    """The planes of ``tools/kabl3.py`` (``kabl3.py:168-180``): 55 Hz
    harmonic rotations, a unit oscillator, envelopes at ``cur * 0.999``,
    steps 0-63."""
    return uniform_inputs()[0]


def main(argv=None) -> int:
    return kabl_main("kabl3", argv, __doc__, inputs)


if __name__ == "__main__":
    sys.exit(main())
