"""Ablations of the fused additive voice (K16): the CUDA kernels and the
plain versions.

Counterpart of the JAX package's ablation tools ``tools/kabl.py`` ..
``tools/kabl6.py``: one steady block of the v3 body (K3,
:func:`oscen_tpu_torch.ops.cuda.additive.plain_v3`) for every voice, with
the voices mixed into ``y``, with one cost removed or one mechanism swapped.
Three kernels:

- ``kabl_tick`` (kernel A, ``csrc/kabl.cu``): K3's layout, time segments
  included, with each ablation a compile-time switch;
- ``kabl_mma`` (kernel B, same file): the variants whose TPU form is an MXU
  product, as ``mma.sync`` bf16 products (one-hot rows, the bf16 reduce);
- ``kabl_hmaj`` (kernel C, ``csrc/kabl_hmaj.cu``): the harmonic-major form
  of ``kabl5``.

Each kernel splits every voice's block into time segments
(:func:`segments` asks the built library how many) and rebuilds each
segment's start state bit for bit, so its outputs are one warp's per voice
(``tests/test_torch_kabl_segments.py`` models the replays on the CPU
against :func:`plain_body` / :func:`plain_hmaj_body`, the plain versions
from any subgroup's state).

:data:`VARIANTS` names the kernel bodies by what they switch; ``TOOLS``
maps each tool's variant names to them (``oscen_tpu_torch/tools``).
Layouts are the tools': planes ``[H, V]`` (the kernels take H = 32, the
plain versions any H), ``step`` ``[1, V]``, ``y`` ``[B, 1]`` (``[B, 128 *
tiles]`` for the harmonic-major form).  ``cur_o`` is the final target, or
the input ``cur`` where the tool keeps it (``cur_in``, kabl6's v5).

Selection: a CPU tensor runs the plain version, a CUDA tensor runs the
kernel (built at first use) or raises.  ``launches`` counts each kernel's
launches; the plain versions are not counted.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

INTERP = 64.0
NUM_HARMONICS = 32
TBL_COLS = 72        # the tools' PAD: one-hot table width
TICK_WARPS = 2       # voices per CUDA block, kernel A
MMA_WARPS = 8        # voices per CUDA block, kernel B
HMAJ_VOICES = 32     # voices per CUDA block, kernel C
MIX_GROUP = 16
KERNEL_A, KERNEL_B, KERNEL_C = "kabl_tick", "kabl_mma", "kabl_hmaj"
PLANES = ("osc_re", "osc_im", "mul_re", "mul_im", "cur", "tgt", "mult")
HMAJ_PLANES = ("osc_re", "osc_im", "ti3", "tr3", "msr", "msi", "cur", "tgt",
               "mult")
launches: Dict[str, int] = {KERNEL_A: 0, KERNEL_B: 0, KERNEL_C: 0}


class Spec(NamedTuple):
    sub: int
    rows: str   # recur recur2 fixed const base loads scan dot32 dot4
                # onehot_sub onehot_all
    amp: str    # full tgt none
    im: str     # rot zr
    red: str    # sum lane0 defer mma
    out: str    # store drop
    prec: str   # f32 bf16


def _s(sub=32, rows="recur", amp="full", im="rot", red="sum", out="store",
       prec="f32"):
    return Spec(sub, rows, amp, im, red, out, prec)


# the kernel bodies, in the order of oscen_kabl's variant codes
VARIANTS: Dict[str, Spec] = {
    "full": _s(),
    "no_amp": _s(amp="tgt"),
    "no_rows": _s(rows="fixed"),
    "no_env": _s(amp="none"),
    "no_reduce": _s(red="lane0"),
    "base": _s(rows="base"),
    "recur": _s(rows="recur2"),
    "loads": _s(rows="loads"),
    "sub64": _s(sub=64),
    "bf16_vpu": _s(prec="bf16"),
    "const_rows": _s(rows="const"),
    "noim": _s(im="zr"),
    "noout": _s(out="drop"),
    "defmix": _s(red="defer"),
    "defmix64": _s(sub=64, red="defer"),
    "scan": _s(rows="scan"),
    "scan64": _s(sub=64, rows="scan"),
    "dot32": _s(rows="dot32"),
    "dot4": _s(rows="dot4"),
    "onehot_sub": _s(rows="onehot_sub"),
    "onehot_all": _s(rows="onehot_all"),
    "bf16_mxu": _s(red="mma", prec="bf16"),
}
ONEHOT_ROWS = ("dot32", "dot4", "onehot_sub", "onehot_all")
HMAJ = {"hmaj_cp": (False, 1), "hmaj_x": (True, 1), "hmaj_t2": (False, 2)}


class Run(NamedTuple):
    """How a tool's variant runs: ``body`` a key of :data:`VARIANTS`, of
    :data:`HMAJ`, or ``k3`` / ``k1`` (the additive kernels at SUB=32)."""
    body: str
    u: int = 64
    cur_in: bool = False


TOOLS: Dict[str, Dict[str, Run]] = {
    "kabl": {"full": Run("full"), "no_amp": Run("no_amp"),
             "no_rows": Run("no_rows"), "no_env": Run("no_env"),
             "no_reduce": Run("no_reduce")},
    "kabl2": {"base": Run("base"), "recur": Run("recur"),
              "loads": Run("loads"), "dot32": Run("dot32"),
              "dot4": Run("dot4"), "v4": Run("onehot_sub"),
              "v5": Run("onehot_all")},
    "kabl3": {"v3b": Run("full"), "v3b64": Run("sub64"),
              "bf16_vpu": Run("bf16_vpu"), "bf16_mxu": Run("bf16_mxu")},
    "kabl4": {"v3b": Run("full"), "norows": Run("const_rows"),
              "noamp": Run("no_amp"), "noim": Run("noim"),
              "nored": Run("no_reduce"), "noout": Run("noout"),
              "defmix": Run("defmix"), "defmix64": Run("defmix64")},
    "kabl5": {"v3b": Run("full"), "hmaj_cp": Run("hmaj_cp"),
              "hmaj_x": Run("hmaj_x"), "hmaj_t2": Run("hmaj_t2")},
    # u128: U = 128 is a TPU unroll knob; on the card it is v5's launch
    "kabl6": {"v3b": Run("k3"), "v4": Run("k1"),
              "v5": Run("scan", cur_in=True),
              "v5s64": Run("scan64", cur_in=True),
              "u128": Run("scan", u=128, cur_in=True)},
}


def kernel_of(body: str) -> str:
    """The CUDA kernel that runs a body of :data:`VARIANTS` / :data:`HMAJ`."""
    if body in HMAJ:
        return KERNEL_C
    sp = VARIANTS[body]
    return KERNEL_B if sp.rows in ONEHOT_ROWS or sp.red == "mma" \
        else KERNEL_A


def zero_table(B: int, device) -> torch.Tensor:
    """The tools' one-hot table input: ``[4B, 72]`` bf16 zeros."""
    return torch.zeros((4 * B, TBL_COLS), dtype=torch.bfloat16,
                       device=device)


# per device: the mix's ticket counters (zero between launches)
_counters: Dict[torch.device, torch.Tensor] = {}


def _mix_scratch(dev, n_blk: int, B: int, tiles: int = 1,
                 words_per_tile: int = 1):
    """The fixed-order mix's rows, per tile, and zeroed ticket counters,
    shared by every launch (each leaves them zeroed; launches on one
    stream): kernels A and B count every time segment in its own field of
    the ``1 + groups`` words, kernel C in ``words_per_tile`` (its segments)
    sets of its own."""
    n_grp = -(-n_blk // MIX_GROUP)
    part = torch.empty((tiles * (n_blk + n_grp), B), dtype=torch.float32,
                       device=dev)
    n = tiles * words_per_tile * (1 + n_grp)
    cnt = _counters.get(dev)
    if cnt is None or cnt.numel() < n:
        cnt = _counters[dev] = torch.zeros((n,), dtype=torch.int32,
                                           device=dev)
    return part, cnt


def segments(body: str, V: int, B: int, U: int = 64) -> int:
    """Time segments per voice the card runs ``body`` (a key of
    :data:`VARIANTS` or :data:`HMAJ`, or ``k3`` / ``k1``) in at ``V``
    voices, ``B`` ticks and body length ``U``, as the built library picks
    them: kernels A and B by K1's rule (``csrc/additive_common.cuh``'s
    ``segments()``: 4, halved until they divide the subgroups and their
    ticket fields hold the voice groups; defer and drop halve further until
    U divides a segment), kernel C 16, halved until they divide the
    subgroups, ``k3`` / ``k1`` K3's and K1's own at SUB=32.  Card only
    (it loads the library)."""
    import ctypes

    from . import build
    if body in ("k3", "k1"):
        from . import additive
        return additive.segments(V, B, 32)
    if body in HMAJ:
        fn = build.load_library("kabl_hmaj").oscen_kabl_hmaj_segments
        fn.argtypes = [ctypes.c_int]
        args = (B,)
    else:
        fn = build.load_library("kabl").oscen_kabl_segments
        fn.argtypes = [ctypes.c_int] * 4
        args = (list(VARIANTS).index(body), V, B, U)
    fn.restype = ctypes.c_int
    segs = fn(*args)
    if segs < 1:
        raise ValueError(f"{body}: no segments for V={V} B={B} U={U}")
    return segs


def _check_operands(dev, H, **ops):
    """What the kernels take: ``name=(tensor, shape)`` contiguous float32
    tensors of exactly those shapes on ``dev``, and H = 32 harmonics."""
    from . import build
    build.check_operands(dev, **{nm: t for nm, (t, _) in ops.items()})
    for nm, (t, shape) in ops.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{nm} must be {list(shape)} (got "
                             f"{list(t.shape)})")
    if H != NUM_HARMONICS:
        raise ValueError(f"the kernels take {NUM_HARMONICS} harmonics "
                         f"(got {H})")


# K3's per-voice y bound on the card (chip_smoke.py Y_TOL)
Y_TOL = 5e-5


def y_bound(tool: str, name: str, y_plain: torch.Tensor, V: int) -> float:
    """The bound a variant's kernel ``y`` is held to against its plain
    version on the card, by the precision of its body.  f32 bodies (the
    tensor-core rows too: a one-hot product of bf16 values is exact in
    f32): the harmonic and voice sums run in another order; K3's
    ``Y_TOL`` per voice, or 2 ulp (2^-22) of the mix's scale where the
    tools' mixes reach 1e3, adding over the V voices in quadrature
    (x sqrt(V)).  bf16 bodies: kernel and plain version round to bf16 at
    the same places, so they differ by the f32 sum order (read 6e-8 of
    the scale on the H100) and by the rare product where PyTorch's float
    add then cast rounds twice and the kernel's bf16 add once (one bf16
    ulp of a product each).  1e-5 of the scale admits a few of those,
    while a body that skipped the roundings misses by 7.6e-4 of it (the
    f32 body's plain y against the bf16 bodies' on kabl3's inputs)."""
    body = TOOLS[tool][name].body
    scale = float(y_plain.abs().max())
    if body in VARIANTS and VARIANTS[body].prec == "bf16":
        return 1e-5 * scale
    return max(Y_TOL, 2.0 ** -22 * scale) * V ** 0.5


# --------------------------------------------------------------------- #
# tick-major bodies: kernels A and B
# --------------------------------------------------------------------- #
def kabl_block(body: str, osc_re, osc_im, mul_re, mul_im, cur, tgt, mult,
               step, B: int, U: int = 64, cur_in: bool = False,
               tbl: Optional[torch.Tensor] = None):
    """One steady block of ``body``; returns ``(y [B, 1], osc_re, osc_im,
    cur, tgt, step [1, V])``.  ``tbl``: the one-hot variants' ``[4B, 72]``
    bf16 table (zeros, as the tools pass it, when None)."""
    sp = VARIANTS[body]
    H, V = osc_re.shape
    if tuple(step.shape) != (1, V):
        raise ValueError(f"step must be [1, {V}] (got {tuple(step.shape)})")
    if B % sp.sub or B % U or U % sp.sub:
        raise ValueError(f"{body}: B={B} and U={U} must be multiples of "
                         f"SUB={sp.sub}")
    if sp.rows in ONEHOT_ROWS and tbl is None:
        tbl = zero_table(B, osc_re.device)
    if sp.rows in ONEHOT_ROWS and tuple(tbl.shape) != (4 * B, TBL_COLS):
        raise ValueError(f"tbl must be [{4 * B}, {TBL_COLS}]")
    planes = (osc_re, osc_im, mul_re, mul_im, cur, tgt, mult)
    if osc_re.device.type == "cpu":
        return plain_block(body, *planes, step, B, U, cur_in, tbl)
    if osc_re.device.type != "cuda":
        raise ValueError(f"no {body} kernel for device {osc_re.device}")
    from . import build
    dev = osc_re.device
    _check_operands(dev, H, step=(step, (1, V)), **{
        nm: (t, (H, V)) for nm, t in zip(PLANES, planes)})
    if tbl is not None and (tbl.device != dev or tbl.dtype != torch.bfloat16
                            or not tbl.is_contiguous()):
        raise ValueError("tbl must be a contiguous bfloat16 tensor on "
                         f"{dev}")
    kern = kernel_of(body)
    nw = MMA_WARPS if kern == KERNEL_B else TICK_WARPS
    y = torch.empty((B,), dtype=torch.float32, device=dev)
    part = cnt = keep = None
    if sp.out == "store":
        part, cnt = _mix_scratch(dev, -(-V // nw), B)
    else:
        keep = torch.empty((H, V), dtype=torch.float32, device=dev)
    outs = [torch.empty((H, V), dtype=torch.float32, device=dev)
            for _ in range(4)]
    step_o = torch.empty((1, V), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    fn = build.entry("kabl", "oscen_kabl", 18, 5)
    rc = fn(*[t.data_ptr() for t in planes], step.data_ptr(), ptr(tbl),
            y.data_ptr(), ptr(part), ptr(cnt), ptr(keep),
            *[t.data_ptr() for t in outs], step_o.data_ptr(),
            list(VARIANTS).index(body), V, B, U, int(cur_in),
            torch.cuda.current_stream(dev).cuda_stream)
    launches[kern] += 1
    build.check_launch("kabl", rc, f"{kern} {body}")
    return (y[:, None], *outs, step_o)


def _rows_recur(p, s, sub):
    """v3's per-tick row chain over one subgroup."""
    wrapped = torch.zeros_like(s, dtype=torch.bool)
    r1s, r2s = [], []
    for _ in range(sub):
        wrap = s == 0.0
        wrapped = torch.logical_or(wrapped, wrap)
        p = torch.where(wrap, 63.0 / 64.0, p * (1.0 - (s + 1.0) / INTERP))
        r1s.append(torch.where(wrapped, 0.0, p))
        r2s.append(torch.where(wrapped, 1.0 - p, 0.0))
        s = torch.where(s < INTERP, s + 1.0, 0.0)
    return r1s, r2s, p, s, wrapped


def rows_scan(p, s, sub):
    """kabl6 / kabl5 ``rows_for``: the subgroup's rows as ``[SUB, V]``
    planes by the masked log-step cumprod (Hillis-Steele order); returns
    ``(r1, r2, p, s, w_last)``."""
    J = torch.arange(sub, dtype=torch.float32, device=s.device)[:, None]
    S = s + J
    s0z = s == 0.0
    wrapped = torch.logical_or(S >= 65.0, s0z)
    shift = torch.where(s0z, 0.0, 65.0)
    seff = torch.where(wrapped, S - shift, S)
    a = (63.0 - seff) * (1.0 / 64.0)
    am = torch.where(wrapped, a, 1.0)
    ap = torch.where(wrapped, 1.0, a)
    sh = 1
    while sh < sub:
        mask = J >= float(sh)
        am = torch.where(mask, am * torch.roll(am, sh, 0), am)
        ap = torch.where(mask, ap * torch.roll(ap, sh, 0), ap)
        sh *= 2
    r1 = p * torch.where(wrapped, 0.0, ap)
    r2 = torch.where(wrapped, 1.0 - am, 0.0)
    p_out = torch.where(wrapped[-1:], am[-1:], p * ap[-1:])
    se_last = seff[-1:]
    s_out = torch.where(se_last < 64.0, se_last + 1.0, 0.0)
    return r1, r2, p_out, s_out, wrapped[-1:]


def _defer_sum(prod):
    """defmix's per-tick finish in the tool's order: halve the harmonics to
    8 rows, the voices to 128 columns, then sum the partial."""
    t = prod
    while t.shape[0] > 8:
        h = t.shape[0] // 2
        t = t[:h] + t[h:]
    while t.shape[1] > 128:
        w = t.shape[1] // 2
        t = t[:, :w] + t[:, w:]
    return t.sum()


def entry_state(osc_re, osc_im, cur, tgt, step):
    """The block-start state ``(zr, zi, tgt, D, s, p)`` of the tick-major
    bodies: a wrap at the first tick takes its cycle base from ``cur``."""
    tgt = torch.where(step == 0.0, cur, tgt)
    return osc_re, osc_im, tgt, cur - tgt, step, torch.ones_like(step)


def plain_body(body: str, state, mul_re, mul_im, mult, k0: int, k1: int,
               step0=None, tbl=None):
    """Subgroups ``k0 .. k1 - 1`` of ``body``'s block from ``state`` (the
    state at subgroup ``k0``, as :func:`entry_state` gives it at 0), in the
    tools' op order; returns (one value per tick: the per-voice harmonic
    sums ``[V]`` (lane 0's product with ``red="lane0"``), or the tick's
    tree sum with ``red="defer"``; the state after subgroup ``k1 - 1``).
    The one-hot rows take the table ``tbl`` and the block's entry step
    ``step0``."""
    sp = VARIANTS[body]
    SUB = sp.sub
    bf = torch.bfloat16
    lowp = sp.prec == "bf16"
    mr, mi = mul_re, mul_im
    mjr, mji = [mr], [mi]
    for _ in range(SUB - 1):
        pr, pi = mjr[-1], mji[-1]
        mjr.append(pr * mr - pi * mi)
        mji.append(pr * mi + pi * mr)
    msr, msi = mjr[-1], mji[-1]
    mji3 = [m * 3.0 for m in mji]
    mjr3 = [m * 3.0 for m in mjr]
    if lowp:
        mji3 = [m.to(bf) for m in mji3]
        mjr3 = [m.to(bf) for m in mjr3]
    scr = oh = None
    if sp.rows in ONEHOT_ROWS:
        B = tbl.shape[0] // 4
        iota = torch.arange(TBL_COLS, device=step0.device)[:, None]
        oh = (iota == step0.to(torch.int32)).to(torch.float32)   # [72, V]
        tblf = tbl.to(torch.float32)
        if sp.rows == "onehot_all":
            scr = tblf[:2 * B] @ oh + tblf[2 * B:4 * B] @ oh     # [2B, V]
        # dot32 / dot4: products the tool discards (nothing reads them)

    zr, zi, tgt, D, s, p = state
    rows = []
    for k in range(k0, k1):
        tgtm = tgt * mult
        G1 = tgtm - tgt
        wrapped = torch.zeros_like(s, dtype=torch.bool)
        if sp.rows in ("recur", "recur2"):
            r1s, r2s, p, s, wrapped = _rows_recur(p, s, SUB)
        elif sp.rows in ("fixed", "base", "dot32", "dot4"):
            r1s, r2s = [p * 0.5] * SUB, [p * 0.25] * SUB
        elif sp.rows == "const":
            r1s = [torch.tensor(0.9 - 0.001 * j, dtype=torch.float32)
                   for j in range(SUB)]
            r2s = [torch.tensor(0.001 * j, dtype=torch.float32)
                   for j in range(SUB)]
        elif sp.rows == "loads":
            r1s = r2s = [torch.zeros_like(s)] * SUB
        elif sp.rows == "scan":
            r1P, r2P, p_n, s_n, w_scan = rows_scan(p, s, SUB)
            r1s, r2s = list(r1P[:, None]), list(r2P[:, None])
        elif sp.rows == "onehot_sub":
            out = tbl[k * 4 * SUB:(k + 1) * 4 * SUB].to(torch.float32) @ oh
            sc = out[:2 * SUB] + out[2 * SUB:]
            r1s, r2s = list(sc[:SUB, None]), list(sc[SUB:, None])
        else:   # onehot_all
            r1s = list(scr[k * SUB:(k + 1) * SUB, None])
            r2s = list(scr[B + k * SUB:B + (k + 1) * SUB, None])
        if lowp:
            zrb, zib, tgtb, Db, G1b = (x.to(bf) for x in (zr, zi, tgt, D,
                                                            G1))
        for j in range(SUB):
            if lowp:
                ampb = (r2s[j].to(bf) * G1b + (r1s[j].to(bf) * Db + tgtb))
                imb = zrb * mji3[j] + zib * mjr3[j]
                prod = (imb * ampb).to(torch.float32)
            else:
                amp = tgt if sp.amp == "tgt" else r2s[j] * G1 + (
                    r1s[j] * D + tgt)
                im = zr if sp.im == "zr" else zr * mji3[j] + zi * mjr3[j]
                prod = im if sp.amp == "none" else im * amp
            if sp.red == "defer":
                rows.append(_defer_sum(prod))
            else:
                rows.append(prod[0] if sp.red == "lane0"
                            else prod.sum(dim=0))   # [V]
        zr, zi = zr * msr - zi * msi, zr * msi + zi * msr
        if sp.rows in ("recur", "fixed"):
            w_last = wrapped
        elif sp.rows == "recur2":
            w_last = torch.logical_or(s == 0.0, s >= 66.0 - SUB)
        elif sp.rows == "const":
            s = torch.where(s + float(SUB) < INTERP + 1.0, s + float(SUB), s)
            w_last = s == 0.0
        elif sp.rows == "scan":
            w_last, p, s = w_scan, p_n, s_n
        else:
            w_last = torch.logical_or(s == 0.0, s >= 66.0 - SUB)
            s = s + float(SUB)
            s = torch.where(s >= 65.0, s - 65.0, s)
        tgt = torch.where(w_last, tgtm, tgt)
        D = torch.where(w_last, -G1, D)
    return rows, (zr, zi, tgt, D, s, p)


def plain_block(body: str, osc_re, osc_im, mul_re, mul_im, cur, tgt, mult,
                step, B: int, U: int = 64, cur_in: bool = False, tbl=None):
    """The tools' kernels in plain PyTorch, per subgroup and tick in their
    op order: ``make_kernel`` of ``kabl.py:22``, ``kabl2.py:26``,
    ``kabl3.py:21``, ``kabl4.py:35``, ``kabl6.py:37``
    (:func:`plain_body` over the whole block, then the mix)."""
    sp = VARIANTS[body]
    rows, (zr, zi, tgt, _, s, _) = plain_body(
        body, entry_state(osc_re, osc_im, cur, tgt, step), mul_re, mul_im,
        mult, 0, B // sp.sub, step, tbl)
    if sp.red == "defer":
        ys = rows
    elif sp.out == "drop":
        # y = 0 + Y[0, 0] * 0 per body of U ticks (kabl4.py:149)
        ys, y00 = [], None
        for t, row in enumerate(rows):
            if t % U == 0:
                y00 = row[0]
            ys.append(0.0 + y00 * 0.0)
    else:
        ys = [row.sum() for row in rows]
    return (torch.stack(ys)[:, None], zr, zi, (cur if cur_in else tgt), tgt,
            s)


# --------------------------------------------------------------------- #
# harmonic-major: kernel C
# --------------------------------------------------------------------- #
def hmaj_tables(th, sub: int = 32):
    """kabl5's frequency-only tables from the rotation angles ``th``
    ``[H, V]`` (float64 numpy): ``ti3`` / ``tr3`` = 3 sin / 3 cos((j + 1)
    th) as ``[H * SUB, V]``, ``msr`` / ``msi`` = cos / sin(SUB th), as
    float32 numpy (``kabl5.py:300-306``)."""
    import numpy as np
    H, V = th.shape
    jj = np.arange(1, sub + 1)[None, :, None]
    f32 = np.float32
    ang = jj * th[:, None, :]
    return dict(ti3=(3.0 * np.sin(ang)).reshape(H * sub, V).astype(f32),
                tr3=(3.0 * np.cos(ang)).reshape(H * sub, V).astype(f32),
                msr=np.cos(sub * th).astype(f32),
                msi=np.sin(sub * th).astype(f32))


def ref_rows(p0, s0, B: int):
    """kabl5's ``ref_rows`` (``kabl5.py:267``): the per-tick recurrence in
    numpy, wrapped flags reset every 32 ticks -> r1 / r2 ``[B, V]``."""
    import numpy as np
    p = p0.copy()
    s = s0.copy()
    wrapped = np.zeros_like(s, dtype=bool)
    r1 = np.zeros((B,) + p.shape[1:], np.float32)
    r2 = np.zeros_like(r1)
    SUB = 32
    for j in range(B):
        if j % SUB == 0:
            wrapped[:] = False
        wrap = s == 0.0
        wrapped |= wrap
        p = np.where(wrap, np.float32(63.0 / 64.0),
                     p * (1.0 - (s + 1.0) / 64.0)).astype(np.float32)
        r1[j] = np.where(wrapped, 0.0, p)
        r2[j] = np.where(wrapped, 1.0 - p, 0.0)
        s = np.where(s < 64.0, s + 1.0, 0.0).astype(np.float32)
    return r1, r2


def hmaj_block(body: str, osc_re, osc_im, ti3, tr3, msr, msi, cur, tgt,
               mult, step, B: int, r1=None, r2=None):
    """One steady block of the harmonic-major form (``hmaj_cp``,
    ``hmaj_x`` with rows ``r1`` / ``r2`` ``[B, V]``, ``hmaj_t2``); returns
    ``(y [B, 128 * tiles], osc_re, osc_im, cur, tgt, step [1, V])``."""
    ext, tiles = HMAJ[body]
    H, V = osc_re.shape
    SUB = ti3.shape[0] // H
    if ext and (r1 is None or r2 is None):
        raise ValueError(f"{body} reads its rows: give r1 and r2 [B, V]")
    if tuple(step.shape) != (1, V) or B % SUB or V % tiles:
        raise ValueError(f"{body}: step [1, {V}], B a multiple of {SUB}, V "
                         f"of {tiles}")
    planes = (osc_re, osc_im, ti3, tr3, msr, msi, cur, tgt, mult)
    if osc_re.device.type == "cpu":
        return plain_hmaj(body, *planes, step, B, r1, r2)
    if osc_re.device.type != "cuda":
        raise ValueError(f"no {body} kernel for device {osc_re.device}")
    from . import build
    dev = osc_re.device
    if SUB != 32 or V % (HMAJ_VOICES * tiles):
        raise ValueError(f"the kernel takes SUB=32 and V a multiple of "
                         f"{HMAJ_VOICES * tiles} (got {SUB}, {V})")
    ops = {nm: (t, (H * SUB, V) if nm in ("ti3", "tr3") else (H, V))
           for nm, t in zip(HMAJ_PLANES, planes)}
    ops["step"] = (step, (1, V))
    if ext:
        ops.update(r1=(r1, (B, V)), r2=(r2, (B, V)))
    _check_operands(dev, H, **ops)
    y = torch.empty((B, 128 * tiles), dtype=torch.float32, device=dev)
    part, cnt = _mix_scratch(dev, V // HMAJ_VOICES // tiles, B, tiles,
                             segments(body, V, B))
    outs = [torch.empty((H, V), dtype=torch.float32, device=dev)
            for _ in range(4)]
    step_o = torch.empty((1, V), dtype=torch.float32, device=dev)
    fn = build.entry("kabl_hmaj", "oscen_kabl_hmaj", 20, 4)
    rc = fn(*[t.data_ptr() for t in planes], step.data_ptr(),
            r1.data_ptr() if ext else None, r2.data_ptr() if ext else None,
            y.data_ptr(), part.data_ptr(), cnt.data_ptr(),
            *[t.data_ptr() for t in outs], step_o.data_ptr(), int(ext),
            tiles, V, B, torch.cuda.current_stream(dev).cuda_stream)
    launches[KERNEL_C] += 1
    build.check_launch("kabl_hmaj", rc, f"{KERNEL_C} {body}")
    return (y, *outs, step_o)


def plain_hmaj_body(state, ti3, tr3, msr, msi, mult, k0: int, k1: int,
                    r1=None, r2=None):
    """Subgroups ``k0 .. k1 - 1`` of ``make_hmaj`` (``kabl5.py:113``) from
    ``state`` (the state at subgroup ``k0``): per subgroup the rows
    (cumprod, or read from ``r1`` / ``r2`` ``[B, V]``), then the harmonic
    loop over ``[SUB, V]`` accumulators; returns (the accumulators of each
    subgroup, the state after subgroup ``k1 - 1``)."""
    zr, zi, tgt, D, s, p = state
    H, V = zr.shape
    SUB = ti3.shape[0] // H
    accs = []
    for k in range(k0, k1):
        if r1 is not None:
            r1P, r2P = r1[k * SUB:(k + 1) * SUB], r2[k * SUB:(k + 1) * SUB]
            _, _, p, s, w_last = rows_scan(p, s, SUB)
        else:
            r1P, r2P, p, s, w_last = rows_scan(p, s, SUB)
        tgtm = tgt * mult
        G1 = tgtm - tgt
        acc = torch.zeros((SUB, V), dtype=torch.float32, device=zr.device)
        for h in range(H):
            Mi = ti3[h * SUB:(h + 1) * SUB]
            Mr = tr3[h * SUB:(h + 1) * SUB]
            im = zr[h:h + 1] * Mi + zi[h:h + 1] * Mr
            amp = r1P * D[h:h + 1] + tgt[h:h + 1]
            amp = r2P * G1[h:h + 1] + amp
            acc = acc + im * amp
        accs.append(acc)
        zr, zi = zr * msr - zi * msi, zr * msi + zi * msr
        tgt = torch.where(w_last, tgtm, tgt)
        D = torch.where(w_last, -G1, D)
    return accs, (zr, zi, tgt, D, s, p)


def plain_hmaj(body: str, osc_re, osc_im, ti3, tr3, msr, msi, cur, tgt,
               mult, step, B: int, r1=None, r2=None):
    """``make_hmaj`` (``kabl5.py:113``) in plain PyTorch
    (:func:`plain_hmaj_body` over the whole block); each tile's mix
    broadcast over its 128 columns."""
    ext, tiles = HMAJ[body]
    H, V = osc_re.shape
    SUB = ti3.shape[0] // H
    accs, (zr, zi, tgt, _, s, _) = plain_hmaj_body(
        entry_state(osc_re, osc_im, cur, tgt, step), ti3, tr3, msr,
        msi, mult, 0, B // SUB, r1 if ext else None, r2 if ext else None)
    ys = [acc.reshape(SUB, tiles, V // tiles).sum(dim=2)   # [SUB, tiles]
          .repeat_interleave(128, dim=1) for acc in accs]
    return torch.cat(ys), zr, zi, tgt, tgt, s


# --------------------------------------------------------------------- #
# kabl6's v3b and v4: the additive kernels K3 and K1 at SUB = 32
# --------------------------------------------------------------------- #
def production_block(body: str, osc_re, osc_im, mul_re, mul_im, cur, tgt,
                     mult, step, B: int, plain: bool = False):
    """K3 (``k3``) or K1 (``k1``) with the fused mix at SUB=32, the
    subgroup the tool instantiates (``kabl6.py:43-46``); the production
    kernels' state (``cur`` is the last envelope value).  Returns the
    tools' layouts."""
    from . import additive
    version = "v3" if body == "k3" else "v4"
    planes = (osc_re, osc_im, mul_re, mul_im, cur, tgt, mult)
    s = step.reshape(-1)
    if plain or osc_re.device.type == "cpu":
        fn = additive.plain_v3 if version == "v3" else additive.plain_v4
        out = fn(*planes, s, B, 32, True)
    else:
        out = additive._launch(version, planes, s.contiguous(), B, 32, True,
                               None)
    y, *state, s_o = out
    return (y[:, None], *state, s_o.reshape(1, -1))


def run_variant(tool: str, name: str, x: Dict[str, torch.Tensor], B: int,
                plain: bool = False):
    """One block of ``tool``'s variant ``name`` on the inputs ``x`` (the
    planes, ``step``, and where the variant takes them ``tbl``, the kabl5
    tables and rows); ``plain`` runs the plain version on any device."""
    run = TOOLS[tool][name]
    if run.body in ("k3", "k1"):
        return production_block(run.body, *(x[k] for k in PLANES),
                                x["step"], B, plain=plain)
    if run.body in HMAJ:
        fn = plain_hmaj if plain else hmaj_block
        return fn(run.body, *(x[k] for k in HMAJ_PLANES), x["step"], B,
                  x.get("r1"), x.get("r2"))
    tbl = x.get("tbl")
    if VARIANTS[run.body].rows in ONEHOT_ROWS and tbl is None:
        tbl = zero_table(B, x["osc_re"].device)
    fn = plain_block if plain else kabl_block
    return fn(run.body, *(x[k] for k in PLANES), x["step"], B, run.u,
              run.cur_in, tbl)
