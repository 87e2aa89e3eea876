"""K6's short exact wrap and its per-chunk re-run, modelled in PyTorch on
the CPU (``oscen_tpu_torch.ops.cuda.phase.short_wrap`` and
``chunked_phase_scan``, the algorithm of ``csrc/phase.cu``).

The short wrap of ``q = p + dt`` is ``q - (q >= 1)``; the kernel
takes it wherever ``q``'s pattern has neither the sign bit nor bit 30 set
(``q`` in ``[+0, 2)``) and re-runs any chunk with another ``q`` by
``q - floor(q)``.  Held bit for bit (``torch.equal`` on the int32
patterns, so a NaN equals only its own pattern and ``-0`` differs from
``+0``) to ``q - torch.floor(q)``, and the chunked scan to the plain
version and to the JAX package's Pallas kernel in interpret mode.  The
2^32 sweep itself runs on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oscen_tpu.ops.pallas.phase import phase_scan as j_phase_scan
from oscen_tpu_torch.ops.cuda import phase as tphase


def _bits(x):
    return x.contiguous().view(torch.int32)


def _from_bits(b):
    return torch.tensor(np.asarray(b, np.uint32).view(np.int32)).view(
        torch.float32)


def _edges():
    """-0, +-0's denormal neighbours, the neighbours of 1 and 2,
    negatives, +-inf and NaNs."""
    f = np.float32
    one, two = f(1.0), f(2.0)
    vals = [-0.0, 0.0, np.nextafter(f(0), f(1)), -np.nextafter(f(0), f(1)),
            np.float32(1e-40), -np.float32(1e-40),
            np.nextafter(one, f(0)), one, np.nextafter(one, two),
            np.nextafter(two, f(0)), two, np.nextafter(two, f(3)),
            -1.0, -0.5, -np.nextafter(f(0), f(1)) * 3, -2.0, 3.5, 1e30,
            np.inf, -np.inf, np.nan, -np.nan, np.float32(0.99999994),
            np.float32(1.5), np.float32(0.5)]
    bits = np.asarray(vals, np.float32).view(np.uint32).tolist()
    bits += [0x7FC00001, 0xFFC00000, 0x7F800001]   # NaN payloads, sNaN
    return _from_bits(bits)


def _held(q):
    """The kernel's wrap: the short one where it is taken, the reference
    elsewhere; returns (wrapped, reference, outside)."""
    short, outside = tphase.short_wrap(q)
    ref = q - torch.floor(q)
    return torch.where(outside, ref, short), ref, outside


def test_short_wrap_edges_equal_the_floor_wrap():
    q = _edges()
    got, ref, outside = _held(q)
    assert torch.equal(_bits(got), _bits(ref))
    # the short path is taken exactly on [+0, 2)
    inside = (~torch.signbit(q)) & (q < 2.0)
    assert torch.equal(outside, ~inside)


@pytest.mark.parametrize("part", range(4))
def test_short_wrap_on_every_float_in_0_2_at_a_stride(part):
    """[+0, 2) is the patterns 0x00000000 .. 0x3FFFFFFF: every 61st of a
    quarter of them (a prime stride, so every exponent and low-bit pattern
    is met)."""
    lo, hi = part << 28, (part + 1) << 28
    q = _from_bits(np.arange(lo, hi, 61, dtype=np.uint64).astype(np.uint32))
    short, outside = tphase.short_wrap(q)
    assert not bool(outside.any())
    assert torch.equal(_bits(short), _bits(q - torch.floor(q)))


def test_short_wrap_flags_everything_outside():
    """Patterns with the sign bit or bit 30 set, at a stride: every one is
    flagged, and the held wrap equals the reference there too."""
    b = np.arange(0x40000000, 1 << 32, 4099, dtype=np.uint64)
    q = _from_bits(b.astype(np.uint32))
    got, ref, outside = _held(q)
    assert bool(outside.all())
    assert torch.equal(_bits(got), _bits(ref))


def _scan_inputs(V, B, seed, edges):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(0, 1, V).astype(np.float32)
    dt = rng.uniform(0, 0.5, (B, V)).astype(np.float32)
    if edges:
        e = _edges().numpy()
        idx = rng.integers(0, B * V, len(e) * 3)
        dt.reshape(-1)[idx] = np.tile(e, 3)
        p0[0] = -0.0
    return torch.tensor(p0), torch.tensor(dt)


@pytest.mark.parametrize("edges", [False, True], ids=["bench", "edges"])
@pytest.mark.parametrize("V,B", [(1, 1), (1, 33), (3, 64), (33, 100),
                                 (256, 96)])
def test_chunked_scan_equals_plain(V, B, edges):
    """Three chained blocks: before and the carry bit for bit; a bench-like
    dt in (0, 0.5) re-runs no chunk, the edge values re-run some."""
    p0, _ = _scan_inputs(V, B, 0, edges)
    p_plain = p_chunk = p0
    reruns = 0
    for blk in range(3):
        _, dt = _scan_inputs(V, B, blk + 1, edges)
        bp, p_plain = tphase.plain_phase_scan(p_plain, dt)
        bc, p_chunk, r = tphase.chunked_phase_scan(p_chunk, dt)
        assert torch.equal(_bits(bc), _bits(bp))
        assert torch.equal(_bits(p_chunk), _bits(p_plain))
        reruns += r
    assert (reruns > 0) == edges


@pytest.mark.parametrize("V,B", [(1, 37), (3, 64)])
def test_chunked_scan_equals_the_pallas_kernel(V, B):
    rng = np.random.default_rng(V + B)
    p_j = rng.uniform(0, 1, V).astype(np.float32)
    p_t = torch.tensor(p_j)
    for _ in range(3):
        dt = rng.uniform(0.0, 0.3, (B, V)).astype(np.float32)
        bj, p_j = j_phase_scan(jnp.asarray(p_j), jnp.asarray(dt),
                               interpret=True)
        bt, p_t, reruns = tphase.chunked_phase_scan(p_t, torch.tensor(dt))
        assert reruns == 0
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
        np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))


@pytest.mark.parametrize("value,want", [(3.0, 1), (-0.75, 1),
                                        (float("nan"), 2)])
def test_rerun_is_per_lane_and_chunk(value, want):
    """One lane's dt outside the short path re-runs that lane's chunk
    alone (a NaN phase stays NaN, so its lane re-runs every later chunk
    too); the other lanes and chunks stay on the short path."""
    p0 = torch.zeros(4)
    dt = torch.full((96, 4), 0.25)
    dt[40, 2] = value
    before, carry, reruns = tphase.chunked_phase_scan(p0, dt)
    assert reruns == want
    bp, cp = tphase.plain_phase_scan(p0, dt)
    assert torch.equal(_bits(before), _bits(bp))
    assert torch.equal(_bits(carry), _bits(cp))


def test_cpu_tensors_run_the_plain_version():
    """A CPU tensor runs the plain version and launches no kernel."""
    p0, dt = _scan_inputs(3, 70, 5, True)
    n = tphase.launches[tphase.KERNEL]
    got = tphase.phase_scan(p0, dt)
    want = tphase.plain_phase_scan(p0, dt)
    assert tphase.launches[tphase.KERNEL] == n
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("name", ["take_reruns", "wrap_sweep"])
def test_card_only_entries_refuse_the_cpu(name):
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(tphase, name)("cpu")
