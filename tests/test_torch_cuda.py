"""oscen_tpu_torch on a CUDA card: each kernel against its plain PyTorch
version, and the electric-piano and poly-synth slices on the card against
the CPU.

These tests carry the ``cuda`` marker and skip without a card.  This file
imports no jax; on a machine with a card and no JAX run it with the JAX
package's pytest plugin dropped from the default options:

    python -m pytest -o addopts="" -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

from oscen_tpu_torch import raw_midi_event
from oscen_tpu_torch.models.electric_piano import build_electric_piano
from oscen_tpu_torch.models.poly_synth import build_poly_synth
from oscen_tpu_torch.nodes.envelope import _cached_steps
from oscen_tpu_torch.ops.cuda import adsr as kadsr
from oscen_tpu_torch.ops.cuda import additive as add
from oscen_tpu_torch.ops.cuda import iir as kiir
from oscen_tpu_torch.ops.cuda import phase as kphase

pytestmark = pytest.mark.cuda

H = 32
KEYS = ("osc_re", "osc_im", "mul_re", "mul_im", "cur", "tgt", "mult")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(V, seed=0):
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 0.2, (H, V))
    step = rng.integers(0, 65, (V,)).astype(np.float32)
    step[:min(V, 3)] = (0.0, 64.0, 33.0)[:min(V, 3)]
    st = dict(osc_re=rng.normal(size=(H, V)), osc_im=rng.normal(size=(H, V)),
              mul_re=np.cos(th), mul_im=np.sin(th),
              cur=rng.uniform(0, 1, (H, V)), tgt=rng.uniform(0, 1, (H, V)),
              mult=rng.uniform(0.9, 1.0, (H, V)))
    return [np.asarray(st[k], np.float32) for k in KEYS], step


# (V, B): ragged last CUDA block (V odd), and every template instance:
# SUB 8/16/32/64 for v4, 8/16/32 samples per harmonic sum for parity
@pytest.mark.parametrize("V,B", [(3, 8), (40, 48), (256, 96), (256, 64),
                                 (41, 72)])
@pytest.mark.parametrize("with_mix", [False, True])
@pytest.mark.parametrize("version", add.KERNELS)
def test_kernel_matches_plain(cuda, version, V, B, with_mix):
    planes_np, step_np = _inputs(V)
    planes = [torch.as_tensor(p, device=cuda) for p in planes_np]
    s = torch.as_tensor(step_np, device=cuda)
    before = add.launches[version]
    k_out = add.additive_voice_block(*planes, s, B, with_mix=with_mix,
                                     version=version)
    torch.cuda.synchronize()
    assert add.launches[version] == before + 1
    if version == "parity":
        p_out = add.plain_parity(*planes, s, B, with_mix)
    else:
        p_out = add.plain_v4(*planes, s, B, add.subgroup_len(B, version),
                             with_mix)
    assert k_out[0].shape == p_out[0].shape
    tol = 5e-5 * (math.sqrt(V) if with_mix else 1.0)
    assert float((k_out[0] - p_out[0]).abs().max()) <= tol
    # built with --fmad=false: the state rounds exactly as the plain ops
    for a, b in zip(k_out[1:], p_out[1:]):
        assert torch.equal(a, b)


def test_kernel_rejects_what_it_does_not_take(cuda):
    planes_np, step_np = _inputs(8)
    planes = [torch.as_tensor(p, device=cuda) for p in planes_np]
    s = torch.as_tensor(step_np, device=cuda)
    bad = list(planes)
    bad[0] = planes[0].t().contiguous().t()      # non-contiguous
    with pytest.raises(ValueError, match="contiguous"):
        add.additive_voice_block(*bad, s, 64)
    short = [p[:16].contiguous() for p in planes]
    with pytest.raises(ValueError, match="32 harmonics"):
        add.additive_voice_block(*short, s, 64)
    mixed = list(planes)
    mixed[3] = planes[3].cpu()
    with pytest.raises(ValueError, match="contiguous float32"):
        add.additive_voice_block(*mixed, s, 64)


def _slice(device):
    p = build_electric_piano(8).compile(48000.0, block_size=64,
                                        device=device)
    for i, n in enumerate((60, 64, 67, 71)):
        p.queue_event("midi_in", 0 if i < 2 else 17,
                      raw_midi_event([0x90, n, 100]))
    outs = [p.process_block()["out"] for _ in range(5)]
    p.queue_event("midi_in", 5, raw_midi_event([0x80, 60, 0]))
    outs += [p.process_block()["out"] for _ in range(3)]
    return p, torch.cat(outs).cpu()


@pytest.mark.parametrize("version", add.KERNELS)
def test_slice_on_card_matches_cpu(cuda, version, monkeypatch):
    monkeypatch.setenv("OSCEN_ADDITIVE_KERNEL", version)
    add.reset_launches()
    p, a = _slice("cuda")
    assert add.launches[version] == 6   # the steady blocks
    assert all(t.device.type == "cuda"
               for t in (p.state["voices"]["amp"]["current"],
                         p.state["tremolo"]["anchor"]))
    _, b = _slice("cpu")
    assert np.abs(a.numpy() - b.numpy()).max() <= 1e-4


# ------------------------------------------------------------------ #
# the poly-synth slice: phase_scan, tpt_svf_scan, adsr_scan
# ------------------------------------------------------------------ #
SCAN_SHAPES = [(1, 37), (1, 100), (3, 37), (40, 100), (256, 1024)]


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("V,B", SCAN_SHAPES)
def test_phase_scan_kernel_equals_plain(cuda, V, B):
    rng = np.random.default_rng(V + B)
    p = torch.as_tensor(rng.uniform(0, 1, V).astype(np.float32), device=cuda)
    before = kphase.launches["phase_scan"]
    for _ in range(3):   # chained blocks
        dt = torch.as_tensor(rng.uniform(0, 0.3, (B, V)).astype(np.float32),
                             device=cuda)
        k = kphase.phase_scan(p, dt)
        torch.cuda.synchronize()
        assert _equal(k, kphase.plain_phase_scan(p, dt))
        p = k[1]
    assert kphase.launches["phase_scan"] == before + 3


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("V,B", SCAN_SHAPES)
def test_tpt_svf_scan_kernel_equals_plain(cuda, V, B, per_sample):
    rng = np.random.default_rng(V * B)
    shape = (B, V) if per_sample else (V,)

    def T(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    z = [T(rng.standard_normal(V)), T(rng.standard_normal(V))]
    before = kiir.launches["tpt_svf_scan"]
    for _ in range(3):
        x = T(rng.standard_normal((B, V)))
        h, g, k = (T(rng.uniform(0.3, 0.9, shape)),
                   T(rng.uniform(0.05, 0.5, shape)),
                   T(rng.uniform(1.0, 2.0, shape)))
        out = kiir.tpt_svf_scan(x, h, g, k, *z)
        torch.cuda.synchronize()
        assert _equal(out, kiir.plain_tpt_svf_scan(x, h, g, k, *z))
        z = list(out[1:])
    assert kiir.launches["tpt_svf_scan"] == before + 3


def test_tpt_svf_scan_keeps_denormals(cuda):
    """An impulse decaying into the denormal range: the kernel keeps
    denormals (no flush to zero), as the CPU does."""
    x = torch.zeros(3000, 4, device=cuda)
    x[0] = 1.0
    h, g, k = (torch.full((4,), v, device=cuda) for v in (0.5, 0.3, 1.9))
    z = torch.zeros(4, device=cuda)
    out = kiir.tpt_svf_scan(x, h, g, k, z, z)
    assert _equal(out, kiir.plain_tpt_svf_scan(x, h, g, k, z, z))
    tail = out[0][-1].abs()
    assert float(tail.max()) < 1.2e-38 and float(tail.max()) > 0.0


def _adsr_rows(V, cuda, seed=0):
    """The parameter rows of tests/test_pallas.py:274-280 tiled across V
    voices and perturbed: stage lengths and coefficients as the node
    computes them."""
    rng = np.random.default_rng(seed)
    base = np.array([[0.0005, 0.0010, 0.60, 0.0015],
                     [0.0020, 0.0005, 0.25, 0.0008],
                     [0.0010, 0.0030, 0.90, 0.0030]], np.float32)
    params = np.tile(base, (-(-V // 3), 1))[:V]
    params = params * rng.uniform(0.9, 1.1, params.shape).astype(np.float32)
    p = {k: torch.as_tensor(params[:, i], device=cuda)
         for i, k in enumerate(("attack", "decay", "sustain", "release"))}
    a_n, d_n, r_n, a_c, d_c = _cached_steps(p, 48000.0)
    return ([a_n.float(), d_n.float(), r_n.float(), a_c, d_c],
            p["sustain"])


@pytest.mark.parametrize("V,B", SCAN_SHAPES)
def test_adsr_scan_kernel_equals_plain(cuda, V, B):
    """Gate on (attack from 0 at velocity 0.8) through A -> D -> S, then a
    gate-off block through R -> idle, each as chained blocks."""
    rows, sus = _adsr_rows(V, cuda)
    st = torch.zeros(7, V, device=cuda)
    st[0], st[1], st[3], st[5] = 1.0, rows[0], 1.0, 0.8
    sus_p = sus[None].expand(B, V).contiguous()
    before = kadsr.launches["adsr_scan"]
    n = -(-400 // B)
    for i in range(2 * n):
        if i == n:      # gate off: release from the current level
            lvl = st[2].clamp(0, 1)
            st = st.clone()
            st[0], st[1], st[3] = 4.0, rows[2], 0.0
            st[6] = torch.where(lvl <= 0, 0.0, -lvl / rows[2].clamp(min=1))
        out = kadsr.adsr_scan(st, *rows, sus_p)
        torch.cuda.synchronize()
        assert _equal(out, kadsr.plain_adsr_scan(st, *rows, sus_p))
        st = out[1]
        if i == n - 1:
            assert bool((st[0] == 3.0).all())     # all sustaining
    assert bool((st[0] == 0.0).all())             # all back to idle
    assert kadsr.launches["adsr_scan"] == before + 2 * n


def test_scan_wrappers_reject_what_they_do_not_take(cuda):
    x = torch.zeros(16, 8, device=cuda)
    row = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kphase.phase_scan(row, torch.zeros(8, 16, device=cuda).t())
    with pytest.raises(ValueError, match="contiguous float32"):
        kphase.phase_scan(row.cpu(), x)
    with pytest.raises(ValueError, match="contiguous"):
        kiir.tpt_svf_scan(x, torch.zeros(8, 16, device=cuda).t(), row, row,
                          row, row)
    with pytest.raises(ValueError, match="contiguous float32"):
        kiir.tpt_svf_scan(x, row, row, row.cpu(), row, row)
    st7 = torch.zeros(7, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous float32"):
        kadsr.adsr_scan(st7, row, row, row.cpu(), row, row, x)
    with pytest.raises(ValueError, match="contiguous"):
        kadsr.adsr_scan(torch.zeros(8, 7, device=cuda).t(), row, row, row,
                        row, row, x)


def _poly(device, voices=16, B=256):
    p = build_poly_synth(voices).compile(48000.0, block_size=B,
                                         device=device)
    for i in range(voices):
        p.queue_event("midi_in", 3 * i, raw_midi_event([0x90, 40 + i, 100]))
    outs = [p.process_block()["audio_out"] for _ in range(4)]
    p.queue_event("midi_in", 20, raw_midi_event([0x80, 40, 0]))
    p.set_value_with_ramp("cutoff", 900.0, 300)
    outs += [p.process_block()["audio_out"] for _ in range(3)]
    return p, torch.cat(outs).cpu()


def test_poly_synth_on_card_matches_cpu(cuda):
    """Event and steady blocks, a note-off and a cutoff ramp: one
    phase_scan and one tpt_svf_scan per block, and the card within 1e-5 of
    the CPU (the kernels equal their plain versions bit for bit)."""
    kphase.reset_launches()
    kiir.reset_launches()
    p, a = _poly("cuda")
    assert kphase.launches["phase_scan"] == 7
    assert kiir.launches["tpt_svf_scan"] == 7
    assert all(t.device.type == "cuda" for t in
               (p.state["oscs"]["phase"], p.state["filts"]["z0"],
                p.state["envs"]["stage"]))
    _, b = _poly("cpu")
    assert float(b.abs().max()) > 0.01
    assert np.abs(a.numpy() - b.numpy()).max() <= 1e-5
