"""K12's per-lane short wrap, modelled in PyTorch on the CPU (the algorithm
of ``csrc/fm.cu``'s ``fract_phase3_kernel``).

Each lane checks its phase and dt once, on their bits: both with the sign
bit clear and below 1.0f (``[+0, 1)``).  Such a lane keeps every ``q = p +
dt`` in ``[+0, 2)`` for the whole block, so it steps by the short exact
wrap ``q - (q >= 1)``; every other lane steps by ``q - trunc(q)`` (Rust's
``.fract()``).  The model is held bit for bit (``torch.equal`` on the
int32 patterns, so a NaN equals only its own pattern and ``-0`` differs
from ``+0``) to ``plain_fract_phase3``, which
``tests/test_torch_fm_kernels.py`` holds to the JAX package's Pallas
kernel: on the edges (1 - 2^-24, -0.0, the smallest denormal, 1.0,
+-inf, NaN) and on lanes of both kinds in one call, and on
hypothesis-drawn float32 patterns of (p0, dt) in
``tests/test_torch_fract_wrap_props.py``.  The 2^32 sweep of the card's
short wrap runs on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from oscen_tpu_torch.ops.cuda import fm as tfm


def _bits(x):
    return x.contiguous().view(torch.int32)


def _from_bits(b):
    return torch.tensor(np.asarray(b, np.uint32).view(np.int32)).view(
        torch.float32)


def _same_bits(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _in_unit(x):
    """The kernel's check on the bits: the sign clear and below 1.0f."""
    b = _bits(x)
    return (b >= 0) & (b < 0x3F800000)


def _short_wrap(q):
    return q - (q >= 1.0).to(torch.float32)


def model_fract_phase3(phases, dt, B):
    """The kernel's two loops, chosen per lane before the first step;
    also asserts that a short lane's q stays in [+0, 2)."""
    short = _in_unit(phases) & _in_unit(dt)
    out = torch.empty((3, B) + tuple(phases.shape[1:]), dtype=torch.float32)
    p = phases
    for t in range(B):
        out[:, t] = p
        q = p + dt
        qb = _bits(q)
        assert bool(((qb >= 0) & (qb < 0x40000000))[short].all())
        p = torch.where(short, _short_wrap(q), q - torch.trunc(q))
    return (out[0], out[1], out[2], p), short


F32 = np.float32
ONE_MINUS = float(np.nextafter(F32(1), F32(0)))     # 1 - 2^-24
DENORMAL = float(np.nextafter(F32(0), F32(1)))      # 2^-149
EDGES = (ONE_MINUS, -0.0, 0.0, DENORMAL, -DENORMAL, 1.0, 0.5, 0.25, 1.5,
         -0.25, float("inf"), float("-inf"), float("nan"))


def test_edges_equal_the_plain_version():
    """Every pair of edges as one lane's (p0, dt), 3 chained blocks: the
    lanes with both in [+0, 1) take the short wrap (1 - 2^-24 plus itself
    is 2 - 2^-23, exact and below 2), the rest (-0.0, negatives, 1.0 and
    above, +-inf, NaN) the trunc wrap."""
    pairs = [(a, b) for a in EDGES for b in EDGES]
    p = torch.tensor([[a for a, _ in pairs]] * 3, dtype=torch.float32)
    dt = torch.tensor([[b for _, b in pairs]] * 3, dtype=torch.float32)
    unit = {ONE_MINUS, 0.0, DENORMAL, 0.5, 0.25}
    want = [a in unit and b in unit and not (np.signbit(a) or np.signbit(b))
            for a, b in pairs]
    for block in range(3):
        got, short = model_fract_phase3(p, dt, 70)
        if block == 0:   # later blocks start from the carries
            assert short[0].tolist() == want
        assert _same_bits(got, tfm.plain_fract_phase3(p, dt, 70))
        p = got[3]


def test_negative_zero_takes_the_trunc_wrap():
    """-0.0 fails the check: -0 - trunc(-0) is +0, the short wrap's
    -0 - 0 would be -0."""
    z = torch.full((3, 1), -0.0)
    got, short = model_fract_phase3(z, z, 2)
    assert not bool(short.any())
    assert _bits(got[3]).tolist() == [[0], [0], [0]]
    assert _same_bits(got, tfm.plain_fract_phase3(z, z, 2))


@pytest.mark.parametrize("B", [1, 33, 1024])
def test_mixed_lanes_in_one_call(B):
    """The models' lanes (p0 in [0, 1), dt in (0, 0.5)) beside lanes off
    the short wrap (p0 below 0, edge dt) in every warp, 3 chained blocks."""
    rng = np.random.default_rng(B)
    p = rng.uniform(0, 1, (3, 64)).astype(np.float32)
    dt = rng.uniform(0.001, 0.5, (3, 64)).astype(np.float32)
    p[:, 1::2] *= -1
    dt[1, 1:2 * len(EDGES):2] = EDGES
    p, dt = torch.tensor(p), torch.tensor(dt)
    for block in range(3):
        got, short = model_fract_phase3(p, dt, B)
        if block == 0:   # later blocks start from the carries
            assert bool(short[:, 0::2].all())
            assert not bool(short[:, 1::2].any())
        assert _same_bits(got, tfm.plain_fract_phase3(p, dt, B))
        p = got[3]


@pytest.mark.parametrize("part", range(4))
def test_short_wrap_equals_trunc_on_0_2_at_a_stride(part):
    """[+0, 2) is the patterns 0x00000000 .. 0x3FFFFFFF: every 61st of a
    quarter of them against q - trunc(q)."""
    lo, hi = part << 28, (part + 1) << 28
    q = _from_bits(np.arange(lo, hi, 61, dtype=np.uint64).astype(np.uint32))
    assert torch.equal(_bits(_short_wrap(q)), _bits(q - torch.trunc(q)))


def test_the_sweep_refuses_the_cpu():
    """The 2^32 sweep runs the card's kernel; the CPU has none."""
    with pytest.raises(ValueError, match="CUDA device"):
        tfm.wrap_sweep("cpu")
