"""K16 plane rows (``tools/kabl6.py``) and the harmonic-major form
(``tools/kabl5.py``) on the CPU: the plain versions of
``oscen_tpu_torch/ops/cuda/kabl.py`` against the tools' Pallas kernels in
interpret mode, one case per variant, at the bounds
``tests/test_torch_kabl.py`` states.

kabl6's ``v3b`` and ``v4`` are the JAX package's production kernels at
U=64, SUB=32 with the mix, held against the port's K3 / K1 plain versions
at SUB=32.  The h-major reference is kabl5's ``make_hmaj`` fed the same
tables (``hmaj_tables``: 3 sin / 3 cos((j + 1) theta), cos / sin(32
theta)) and, for ``hmaj_x``, the rows of the port's copy of ``ref_rows``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from oscen_tpu_torch.ops.cuda import kabl as tk
from test_torch_kabl import (assert_close, check_variant, hmaj_ref, inputs,
                             tool, torch_inputs)


@pytest.mark.parametrize("variant", ["v5", "v5s64", "u128", "v3b"])
def test_kabl6_matches_pallas_interpret(variant):
    check_variant("kabl6", variant)


def test_kabl6_v4_matches_the_production_kernel():
    """kabl6's ``v4`` binds ``_kernel_v4`` as ``partial(kern, U, SUB,
    True)``, from before the kernel took ``epi_fn`` and ``epi_split``; the
    reference binds those too (no epilogue)."""
    from oscen_tpu.ops.pallas import additive as jadd
    H, V, B = 8, 128, 128
    x, _ = inputs(H, V)
    f32 = jnp.float32
    plane = jax.ShapeDtypeStruct((H, V), f32)
    keys = ("osc_re", "osc_im", "mul_re", "mul_im", "cur", "tgt", "mult",
            "step")
    ref = pl.pallas_call(
        functools.partial(jadd._kernel_v4, 64, 32, True, None, 0),
        out_shape=(jax.ShapeDtypeStruct((B, 1), f32), plane, plane, plane,
                   plane, jax.ShapeDtypeStruct((1, V), f32)),
        interpret=True)(*[jnp.asarray(x[k]) for k in keys])
    port = tk.run_variant("kabl6", "v4", torch_inputs(x), B)
    assert_close(port, [np.asarray(o) for o in ref], what="kabl6 v4")


def test_scan_rows_equal_the_recurrence_to_rounding():
    """The segmented cumprod (``rows_scan``) reassociates v3's serial P
    product: its rows sit within a few ulp of the recurrence's, and its
    step and wrap flags equal them exactly (kabl6.py:14-17)."""
    import torch
    s = torch.arange(65, dtype=torch.float32)[None, :]
    p = torch.full_like(s, 0.7)
    for sub in (32, 64):
        r1P, r2P, p_s, s_s, w_s = tk.rows_scan(p, s, sub)
        r1s, r2s, p_r, s_r, w_r = tk._rows_recur(p, s, sub)
        assert torch.equal(s_s, s_r) and torch.equal(w_s, w_r)
        assert float((r1P - torch.cat(r1s)).abs().max()) <= 1e-6
        assert float((r2P - torch.cat(r2s)).abs().max()) <= 1e-6
        assert float((p_s - p_r).abs().max()) <= 1e-6


def _hmaj_inputs(H=8, V=128, B=128):
    x, th = inputs(H, V)
    x.update(tk.hmaj_tables(th))
    x["r1"], x["r2"] = tk.ref_rows(np.ones((1, V), np.float32), x["step"], B)
    return x


@pytest.mark.parametrize("variant", list(tk.TOOLS["kabl5"]))
def test_kabl5_matches_pallas_interpret(variant):
    B = 128
    if variant == "v3b":
        check_variant("kabl5", variant, B=B)
        return
    x = _hmaj_inputs(B=B)
    ref = hmaj_ref(variant, x, B)
    port = tk.run_variant("kabl5", variant, torch_inputs(x), B)
    assert_close(port, ref, what=f"kabl5 {variant}")


def test_ref_rows_is_the_tools():
    """The port's copy of ``kabl5.ref_rows`` gives the tool's rows."""
    x, _ = inputs(8, 128)
    p0 = np.ones((1, 128), np.float32)
    for a, b in zip(tk.ref_rows(p0, x["step"], 128),
                    tool("kabl5").ref_rows(p0, x["step"], 128)):
        np.testing.assert_array_equal(a, b)
