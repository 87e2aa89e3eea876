"""Plane rows for the tick-major additive body: the segmented cumprod.

Counterpart of the JAX package's ``tools/kabl6.py``, on the card:

  v3b   : K3, the production v3 kernel (``csrc/additive.cu``) at SUB=32
  v4    : K1, the production v4 kernel at SUB=32
  v5    : kernel A (``csrc/kabl.cu``) with each subgroup's rows computed at
          once, lane j row j, by a log-step __shfl_up_sync cumprod, and
          fetched per tick with __shfl_sync; SUB=32
  v5s64 : v5 at SUB=64
  u128  : v5 at U=128, a TPU unroll knob: on the card the same launch as v5

All at H=32 harmonics, V=256 voices, B=1024, float32, with the voice mix.
The parity line gives each variant's y against v3b with the scale, as the
TPU tool prints it.  Timing: see ``oscen_tpu_torch.tools``.

Usage: python -m oscen_tpu_torch.tools.kabl6 [variants...] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from . import kabl_main


def inputs(B: int = 1024, H: int = 32, V: int = 256):
    """``kabl6.py:189-200``: a random oscillator, slow rotations,
    envelopes in [0, 1), steps 0-64."""
    rng = np.random.default_rng(0)
    th = rng.uniform(0.001, 0.2, (H, V))
    x = dict(osc_re=rng.normal(size=(H, V)), osc_im=rng.normal(size=(H, V)),
             mul_re=np.cos(th), mul_im=np.sin(th),
             cur=rng.uniform(0, 1, (H, V)), tgt=rng.uniform(0, 1, (H, V)),
             mult=rng.uniform(0.9, 1.0, (H, V)),
             step=rng.integers(0, 65, (1, V)))
    return {k: np.asarray(v, np.float32) for k, v in x.items()}


def main(argv=None) -> int:
    return kabl_main("kabl6", argv, __doc__, inputs)


if __name__ == "__main__":
    sys.exit(main())
