"""Shared helpers for the hand-written kernels."""

from __future__ import annotations


def pick_unroll(n: int, max_u: int = 64) -> int:
    """Largest power of two <= ``max_u`` dividing ``n``.

    The same choice as the JAX package's ``ops/pallas/util.py``: the
    additive kernel's subgroup length ``SUB = min(U, 64)`` moves the
    closed-form anchor, so the port has to pick ``U`` exactly as the
    reference does to agree with it at 1e-5.  (The reference's
    ``OSCEN_UNROLL_CAP`` compile-time knob has no counterpart here.)
    """
    u = 1
    while u < max_u and n % (u * 2) == 0:
        u *= 2
    while u > max_u:  # non-power-of-two caps: clamp down to a divisor
        u //= 2
    return u
