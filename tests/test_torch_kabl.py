"""K16, the additive-kernel ablations (``tools/kabl.py`` and
``tools/kabl3.py``), on the CPU: the plain versions of
``oscen_tpu_torch/ops/cuda/kabl.py`` against the tools' own Pallas kernels
in interpret mode, one case per variant.

The tools' kernel makers are imported from ``tools/`` by file path
(importing them pulls in no jax: each imports it inside its maker) and run
through ``pl.pallas_call(..., interpret=True)`` without memory spaces, as
``tests/test_torch_additive.py`` runs the package kernels.  This module also
holds the reference helpers ``tests/test_torch_kabl2.py`` and
``tests/test_torch_kabl4.py`` import.

Bounds, each with its reason:

- f32 variants: ``y`` within 2e-6 x max|y|: the harmonic and voice sums
  run in another order, and XLA contracts the interpret kernel's products
  and sums into FMAs on the CPU (PERF.md, Findings);
- every state plane within 1e-5 (absolute, planes of magnitude ~1-4), the
  bound ``tests/test_torch_additive.py`` holds for the same plane
  recurrences: XLA's FMAs in the 31-step m^SUB recurrence move the
  oscillator planes by up to 6e-6 after 4 subgroups (1e-6 does not hold);
- bf16 variants: ``y`` within 1e-2 x max|y|: bf16 rounds at other places in
  XLA's CPU lowering than in PyTorch's separate bf16 ops; the f32 state
  planes keep the f32 bound.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from oscen_tpu_torch.ops.cuda import kabl as tk

ROOT = Path(__file__).resolve().parents[1]
F32_Y, F32_STATE, BF16_Y = 2e-6, 1e-5, 1e-2


@functools.lru_cache(maxsize=None)
def tool(name):
    """``tools/<name>.py`` loaded by file path."""
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(H, V, seed=0, tbl_rows=0):
    """Seeded planes (kabl6's draws: a unit oscillator, slow rotations,
    envelopes in [0, 1)) with the step edge cases 0, 64 and 33 in lanes
    0-2, and a random bf16 one-hot table of ``tbl_rows`` rows (its values
    exact in float32)."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.001, 0.2, (H, V))
    step = rng.integers(0, 65, (1, V)).astype(np.float32)
    step[0, :3] = (0.0, 64.0, 33.0)
    x = dict(osc_re=rng.normal(size=(H, V)), osc_im=rng.normal(size=(H, V)),
             mul_re=np.cos(th), mul_im=np.sin(th),
             cur=rng.uniform(0, 1, (H, V)), tgt=rng.uniform(0, 1, (H, V)),
             mult=rng.uniform(0.9, 1.0, (H, V)), step=step)
    x = {k: np.asarray(v, np.float32) for k, v in x.items()}
    if tbl_rows:
        t = torch.as_tensor(rng.uniform(0, 0.5, (tbl_rows, tk.TBL_COLS))
                            .astype(np.float32)).to(torch.bfloat16)
        x["tbl"] = t.to(torch.float32).numpy()
    return x, th


def torch_inputs(x):
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    if "tbl" in t:
        t["tbl"] = t["tbl"].to(torch.bfloat16)
    return t


SHAPES = {   # tool -> variant -> (U, SUB)
    "kabl": lambda v: (64, 32),
    "kabl2": lambda v: (64, 32),
    "kabl3": lambda v: (64, 64 if v == "v3b64" else 32),
    "kabl4": lambda v: (64, 64 if v.endswith("64") else 32),
    "kabl5": lambda v: (64, 32),
    "kabl6": lambda v: (128 if "u128" in v else 64, 64 if "s64" in v
                        else 32),
}


def pallas_ref(name, variant, x, B):
    """The tool's kernel for ``variant`` in interpret mode on the inputs
    ``x``; returns (y, osc_re, osc_im, cur, tgt, step) as numpy."""
    m = tool(name)
    H, V = x["osc_re"].shape
    U, SUB = SHAPES[name](variant)
    f32 = jnp.float32
    plane = jax.ShapeDtypeStruct((H, V), f32)
    keys = ("osc_re", "osc_im", "mul_re", "mul_im", "cur", "tgt", "mult",
            "step")
    args = [jnp.asarray(x[k]) for k in keys]
    y_shape = jax.ShapeDtypeStruct((B, 1), f32)
    scratch = []
    if name == "kabl":
        kern = m.make_kernel(U, SUB, variant)
    elif name == "kabl2":
        kern = m.make_kernel(U, SUB, variant, B)
        rows = 2 * B if variant in ("loads", "v5") else 4 * SUB
        scratch = [pltpu.VMEM((rows, V), f32)]
        args = [jnp.asarray(x["tbl"], jnp.bfloat16)] + args
    elif name == "kabl3":
        kern = m.make_kernel(U, SUB, variant)
        scratch = [pltpu.VMEM((SUB * 32, V), jnp.bfloat16
                              if variant == "bf16_mxu" else f32)]
    elif name == "kabl4":
        kern = m.make_kernel(U, SUB, variant)
        scratch = [pltpu.VMEM((U * 8, 128), f32)]
    elif name == "kabl5":
        kern = m.make_v3b(U, SUB)
    else:
        kern = m.make_kernel(U, SUB, variant)
    out = pl.pallas_call(
        kern, out_shape=(y_shape, plane, plane, plane, plane,
                         jax.ShapeDtypeStruct((1, V), f32)),
        scratch_shapes=scratch, interpret=True)(*args)
    return [np.asarray(o) for o in out]


def hmaj_ref(variant, x, B):
    """kabl5's h-major kernel (``make_hmaj``) in interpret mode on the
    planes, tables (``ti3``, ``tr3``, ``msr``, ``msi``) and, for hmaj_x,
    rows ``r1``, ``r2`` of ``x``."""
    m = tool("kabl5")
    H, V = x["osc_re"].shape
    ext, tiles = tk.HMAJ[variant]
    tile = V // tiles
    f32 = jnp.float32

    def spec(rows):
        return pl.BlockSpec((rows, tile), lambda i: (0, i))
    keys = ["osc_re", "osc_im", "ti3", "tr3", "msr", "msi", "cur", "tgt",
            "mult", "step"] + (["r1", "r2"] if ext else [])
    in_specs = [spec(x[k].shape[0]) for k in keys]
    plane = jax.ShapeDtypeStruct((H, V), f32)
    out = pl.pallas_call(
        m.make_hmaj(64, 32, H, ext), grid=(tiles,),
        out_shape=(jax.ShapeDtypeStruct((B, 128 * tiles), f32), plane, plane,
                   plane, plane, jax.ShapeDtypeStruct((1, V), f32)),
        in_specs=in_specs,
        out_specs=(pl.BlockSpec((B, 128), lambda i: (0, i)),) + tuple(
            spec(H) for _ in range(4)) + (spec(1),),
        interpret=True)(*[jnp.asarray(x[k]) for k in keys])
    return [np.asarray(o) for o in out]


def assert_close(port, ref, bf16=False, what=""):
    """y and every state plane within the module's bounds."""
    y_t, y_j = np.asarray(port[0]), ref[0]
    assert y_t.shape == y_j.shape, (y_t.shape, y_j.shape)
    scale = float(np.abs(y_j).max())
    err = float(np.abs(y_t - y_j).max())
    assert err <= (BF16_Y if bf16 else F32_Y) * scale, (what, err, scale)
    for i, (a, b) in enumerate(zip(port[1:], ref[1:])):
        np.testing.assert_allclose(np.asarray(a), b, atol=F32_STATE, rtol=0,
                                   err_msg=f"{what} state {i}")


def check_variant(name, variant, H=8, V=128, B=128, tbl_rows=0):
    x, _ = inputs(H, V, tbl_rows=tbl_rows)
    ref = pallas_ref(name, variant, x, B)
    port = tk.run_variant(name, variant, torch_inputs(x), B)
    assert_close(port, ref, bf16=variant.startswith("bf16"),
                 what=f"{name} {variant}")
    return port


@pytest.mark.parametrize("variant", list(tk.TOOLS["kabl"]))
def test_kabl_matches_pallas_interpret(variant):
    check_variant("kabl", variant)


@pytest.mark.parametrize("variant", list(tk.TOOLS["kabl3"]))
def test_kabl3_matches_pallas_interpret(variant):
    # bf16_mxu stages 32 harmonics per tick: H = 32
    check_variant("kabl3", variant,
                  H=32 if variant == "bf16_mxu" else 8)


def test_cpu_tensors_take_the_plain_versions():
    x, _ = inputs(8, 128, tbl_rows=4 * 128)
    t = torch_inputs(x)
    before = dict(tk.launches)
    for name, variants in tk.TOOLS.items():
        if name == "kabl5":
            continue
        for v in variants:
            y, *state = tk.run_variant(name, v, t, 128)
            assert y.shape == (128, 1) and y.device.type == "cpu"
            assert state[-1].shape == (1, 128)
    assert tk.launches == before   # plain versions are not counted


def test_the_kernel_switch_follows_the_variant_table():
    """``oscen_kabl``'s case N launches the template instance of the N-th
    body of ``VARIANTS`` (the codes the wrapper passes)."""
    import re
    src = (ROOT / "oscen_tpu_torch" / "csrc" / "kabl.cu").read_text()
    cases = re.findall(r"case (\d+):\s*// (\w+)\s*return launch<(\d+), (\w+), "
                       r"(\w+), (\w+), (\w+), (\w+), (\w+)>", src)
    names = {"recur": "kRecur", "recur2": "kRecur2", "fixed": "kFixed",
             "const": "kConst", "base": "kBase", "loads": "kLoads",
             "scan": "kScan", "dot32": "kDot32", "dot4": "kDot4",
             "onehot_sub": "kMmaSub", "onehot_all": "kMmaAll",
             "full": "kAmpFull", "tgt": "kAmpTgt", "none": "kAmpNone",
             "rot": "kImRot", "zr": "kImZr", "sum": "kRedSum",
             "lane0": "kRedLane0", "defer": "kRedDefer", "mma": "kRedMma",
             "store": "kOutStore", "drop": "kOutDrop", "f32": "kF32",
             "bf16": "kBf16"}
    assert len(cases) == len(tk.VARIANTS)
    for (code, label, *tmpl), (body, sp) in zip(cases, tk.VARIANTS.items()):
        assert int(code) == list(tk.VARIANTS).index(body) and label == body
        want = [str(sp.sub)] + [names[f] for f in sp[1:]]
        assert tmpl == want, (body, tmpl, want)


def test_wrappers_reject_what_they_do_not_take():
    x, _ = inputs(8, 128)
    t = torch_inputs(x)
    planes = [t[k] for k in tk.PLANES]
    with pytest.raises(ValueError, match="step"):
        tk.kabl_block("full", *planes, t["step"][0], 64)
    with pytest.raises(ValueError, match="SUB"):
        tk.kabl_block("sub64", *planes, t["step"], 96)
    with pytest.raises(ValueError, match="tbl"):
        tk.kabl_block("onehot_all", *planes, t["step"], 64,
                      tbl=tk.zero_table(32, "cpu"))
    with pytest.raises(ValueError, match="no full kernel"):
        tk.kabl_block("full", *[p.to("meta") for p in planes],
                      t["step"].to("meta"), 64)
