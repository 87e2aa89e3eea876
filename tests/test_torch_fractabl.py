"""K17, the fract-phase store-layout ablations (``tools/fractabl.py``,
``tools/fractabl2.py``), on the CPU.

The tools' kernels are nested in their ``main()`` and cannot be imported;
what the tools assert (``fractabl.py:87-91``, ``fractabl2.py:157-163``) is
that every layout equals ``fract_phase3`` bit for bit.  So each layout's
plain version (what the wrapper runs on a CPU tensor, and what
``csrc/fractabl.cu`` is held to on the card) is held ``torch.equal`` to the
JAX package's ``fract_phase3`` in interpret mode (``OSCEN_UNROLL_CAP=1``,
as ``tests/test_torch_fm_kernels.py`` runs it) and to the port's K12 plain
version, over two chained blocks.  ``fractabl2``'s consumer is held to the
same expressions in JAX (``oscen_tpu.ops.fastmath.sin_turns``) bit for
bit: the same float32 ops in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oscen_tpu.ops import fastmath as jfast
from oscen_tpu.ops.pallas import fm as jfm
from oscen_tpu_torch.ops.cuda import fm as tfm
from oscen_tpu_torch.ops.cuda import fractabl as tfa

SHAPES = [(128, 64), (256, 128)]


@pytest.fixture(autouse=True)
def _no_unroll(monkeypatch):
    monkeypatch.setenv("OSCEN_UNROLL_CAP", "1")


@pytest.mark.parametrize("V,B", SHAPES)
@pytest.mark.parametrize("layout", tfa.LAYOUTS)
def test_layout_equals_fract_phase3(layout, V, B):
    rng = np.random.default_rng(V + B)
    p = rng.uniform(-1, 1, (3, V)).astype(np.float32)
    p_j, p_t, p_k = jnp.asarray(p), torch.as_tensor(p), torch.as_tensor(p)
    for _ in range(2):
        dt = rng.uniform(-0.05, 0.4, (3, V)).astype(np.float32)
        oj = jfm.fract_phase3(p_j, jnp.asarray(dt), B, interpret=True)
        ot = tfa.fract_layout(layout, p_t, torch.as_tensor(dt), B)
        ok = tfm.plain_fract_phase3(p_k, torch.as_tensor(dt), B)
        for a, b, c in zip(oj, ot, ok):
            assert torch.equal(b, torch.as_tensor(np.array(a)))
            assert torch.equal(b, c)
        p_j, p_t, p_k = oj[3], ot[3], ok[3]
    assert tfa.launches[tfa.KERNEL] == 0   # plain versions are not counted


def test_raw_layouts():
    """direct and packed store ``[B, 3, V]`` (packed is the tool's ``[B *
    6, 128]`` in memory), seg the j-major ``[SEG, 3 * S, V]``: row ``k * S
    + s`` of step j is operator k at time ``s * SEG + j``."""
    rng = np.random.default_rng(0)
    p = torch.as_tensor(rng.uniform(0, 1, (3, 256)).astype(np.float32))
    dt = torch.as_tensor(rng.uniform(0, 0.02, (3, 256)).astype(np.float32))
    B = 64
    ref = tfm.plain_fract_phase3(p, dt, B)
    direct, _ = tfa.fract_layout_raw("direct", p, dt, B)
    packed, _ = tfa.fract_layout_raw("packed", p, dt, B)
    seg, _ = tfa.fract_layout_raw("seg", p, dt, B)
    assert direct.shape == packed.shape == (B, 3, 256)
    assert torch.equal(packed.reshape(B * 6, 128)[6 * 5 + 3],
                       ref[1][5, 128:])     # step 5, op2, voices 128..255
    assert seg.shape == (B // tfa.S, 3 * tfa.S, 256)
    j, k, s = 3, 2, 5
    assert torch.equal(seg[j, k * tfa.S + s], ref[k][s * (B // tfa.S) + j])


def test_consumer_matches_jax():
    rng = np.random.default_rng(1)
    B, V = 64, 128
    ph = [rng.uniform(0, 1, (B, V)).astype(np.float32) for _ in range(3)]
    e3 = rng.uniform(0, 1, (B, V)).astype(np.float32)
    e2, e1 = np.roll(e3, 1, 0), np.roll(e3, 2, 0)
    mix = rng.uniform(0, 1, (V,)).astype(np.float32)
    mixr = jnp.asarray(mix)[None, :]
    y3 = jfast.sin_turns(jnp.asarray(ph[0])) * e3
    a, b = y3 * (1.0 - mixr), y3 * mixr
    y2 = jfast.sin_turns(jnp.asarray(ph[1]) + a) * e2
    want = jfast.sin_turns(jnp.asarray(ph[2]) + (y2 + b)) * e1
    got = tfa.consume(*(torch.as_tensor(x) for x in ph + [e3, e2, e1, mix]))
    assert torch.equal(got, torch.as_tensor(np.array(want)))


def test_wrapper_rejects_what_it_does_not_take():
    p = torch.zeros(3, 6)
    with pytest.raises(ValueError, match="unknown"):
        tfa.fract_layout("rows", p, p, 8)
    with pytest.raises(ValueError, match="multiple of 8"):
        tfa.fract_layout("seg", p, p, 12)
    with pytest.raises(ValueError, match="even"):
        tfa.fract_layout("packed", torch.zeros(3, 5), torch.zeros(3, 5), 8)
    with pytest.raises(ValueError, match=r"\[3, V\]"):
        tfa.fract_layout("direct", torch.zeros(2, 6), torch.zeros(2, 6), 8)
    with pytest.raises(ValueError, match="no fract_abl kernel"):
        tfa.fract_layout("direct", p.to("meta"), p.to("meta"), 8)


@pytest.mark.parametrize("tool", ["fractabl", "fractabl2"])
def test_driver_parity_line_on_the_cpu(tool, capsys):
    import importlib
    mod = importlib.import_module(f"oscen_tpu_torch.tools.{tool}")
    assert mod.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("True") == len(mod.VARIANTS) and "False" not in out
