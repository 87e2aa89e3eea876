"""The hand-written CUDA kernels (``csrc/*.cu``) and their plain PyTorch
versions, one wrapper module per source."""

from __future__ import annotations

from typing import Dict, List


def launch_counters() -> List[Dict[str, int]]:
    """Every wrapper module's ``launches`` dict (the objects themselves)."""
    from . import additive, adsr, fm, iir, phase
    return [m.launches for m in (additive, adsr, fm, iir, phase)]
