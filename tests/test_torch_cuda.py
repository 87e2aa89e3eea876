"""oscen_tpu_torch on a CUDA card: each kernel against its plain PyTorch
version (the additive voice in all four versions and with the tremolo
epilogue), the electric-piano (fused epilogue or not), poly-synth, FM and
twin-peaks slices, an IIR-lowpass graph, the echo and the 4x saturators
(sinc and IIR-halfband boundaries) on the card against the CPU, a synth
chained into the echo through tensors on the card, the card as the
default device, and the asset slice: a reverb whose steady blocks, publish
and fade never wait for the card, a sampler into a filter and a scope
against the CPU, checkpoint and bundle resumes on the card, and the
streaming host's real-time claims; the voice-class piano against the CPU
and its switches under sync debug mode "error", a numpy state taken
without a wait, and the seven examples against the CPU.

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
from oscen_tpu_torch.models.fm_synth import build_fm_synth
from oscen_tpu_torch.models.pivot import build_pivot
from oscen_tpu_torch.models.poly_synth import build_poly_synth
from oscen_tpu_torch.nodes.envelope import _cached_steps
from oscen_tpu_torch.ops.cuda import adsr as kadsr
from oscen_tpu_torch.ops.cuda import additive as add
from oscen_tpu_torch.ops.cuda import fm as kfm
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
    p_out = add.plain_block(*planes, s, B, with_mix, version)
    assert k_out[0].shape == p_out[0].shape
    tol = 5e-5 * (math.sqrt(V) if with_mix else 1.0)
    assert float((k_out[0] - p_out[0]).abs().max()) <= tol
    # built with --fmad=false: the state rounds exactly as the plain ops
    for a, b in zip(k_out[1:], p_out[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("V,B", [(3, 40), (40, 48), (256, 1024),
                                 (256, 4096), (41, 72)])
def test_v3_kernel_equals_v4_kernel(cuda, V, B):
    """K3 computes K1's float values in K1's order: y and every state plane
    torch.equal over 3 chained blocks, with and without the mix."""
    planes_np, step_np = _inputs(V)
    mr, mi, mult = (torch.as_tensor(planes_np[i], device=cuda)
                    for i in (2, 3, 6))
    for with_mix in (False, True):
        outs = {}
        for version in ("v3", "v4"):
            ore, oim, _, _, cur, tgt, _ = (torch.as_tensor(p, device=cuda)
                                           for p in planes_np)
            s = torch.as_tensor(step_np, device=cuda)
            ys = []
            for _ in range(3):
                y, ore, oim, cur, tgt, s = add.additive_voice_block(
                    ore, oim, mr, mi, cur, tgt, mult, s, B,
                    with_mix=with_mix, version=version)
                ys.append(y)
            outs[version] = ys + [ore, oim, cur, tgt, s]
        torch.cuda.synchronize()
        assert _equal(outs["v3"], outs["v4"])


def _pan_params(cuda, k0, rate=5.0):
    """Tremolo epilogue parameters [anchor, k0, dt, depth, a2] as
    Tremolo.kernel_epilogue builds them."""
    from oscen_tpu_torch import SampleRate, Tremolo
    t = Tremolo()
    st = {"anchor": torch.tensor(0.3, device=cuda),
          "k": torch.tensor(int(k0), dtype=torch.int32, device=cuda),
          "dt_last": torch.tensor(rate / 48000.0, device=cuda)}
    vals = {"rate": torch.tensor(rate, device=cuda),
            "depth": torch.tensor(0.3, device=cuda)}
    return t, st, vals, SampleRate(48000.0)


@pytest.mark.parametrize("V,B,k0", [(3, 40, 10), (256, 1024, 1000),
                                    (256, 4096, (1 << 20) - 1000)])
def test_epilogue_kernel_matches_plain(cuda, V, B, k0):
    """K5 (v4 with the tremolo pan after the mix): state planes torch.equal
    to the plain version and y within the mix bound; y torch.equal to K1's
    mix followed by the plain pan on the card (one mix order, one pan);
    the tremolo's closed-form state advance as Tremolo.process_block."""
    planes_np, step_np = _inputs(V)
    planes = [torch.as_tensor(p, device=cuda) for p in planes_np]
    s = torch.as_tensor(step_np, device=cuda)
    trem, st, vals, sr = _pan_params(cuda, k0)
    C, fn, prm, new_st = trem.kernel_epilogue(st, vals, sr, B)
    before = add.launches[add.EPILOGUE]
    k_out = add.additive_voice_block(*planes, s, B, with_mix=True,
                                     epi_fn=fn, epi_c=C, epi_params=prm)
    torch.cuda.synchronize()
    assert add.launches[add.EPILOGUE] == before + 1
    p_mix = add.plain_block(*planes, s, B, True, "v4")
    p_y = torch.stack(fn(p_mix[0], 0, prm), dim=-1)
    assert k_out[0].shape == (B, 2)
    assert float((k_out[0] - p_y).abs().max()) <= 5e-5 * math.sqrt(V)
    assert _equal(k_out[1:], p_mix[1:])
    k1 = add.additive_voice_block(*planes, s, B, with_mix=True,
                                  version="v4")
    assert torch.equal(k_out[0], torch.stack(fn(k1[0], 0, prm), dim=-1))
    ref_st, ref_out = trem.process_block(
        st, {"input": k1[0], "rate": vals["rate"].expand(B),
             "depth": vals["depth"].expand(B)}, {}, sr, B,
        const_ins=frozenset({"rate", "depth"}))
    assert torch.equal(k_out[0], ref_out["output"])
    assert all(torch.equal(new_st[k], ref_st[k]) for k in ref_st)


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


def test_fused_epilogue_piano_equals_unfused_on_card(cuda, monkeypatch):
    """OSCEN_EPILOGUE_FUSION=1 on the card: one K5 launch per steady block
    and no K1, the output torch.equal to the unfused piano's, including a
    tremolo rate change at a block boundary and a ramping rate (staged
    [B], so the fusion steps aside)."""
    def run(fused):
        monkeypatch.setenv("OSCEN_EPILOGUE_FUSION", "1" if fused else "0")
        add.reset_launches()
        p = build_electric_piano(16).compile(48000.0, block_size=256,
                                             device="cuda")
        for i in range(4):
            p.queue_event("midi_in", 0, raw_midi_event([0x90, 50 + 5 * i,
                                                        100]))
        outs = [p.process_block()["out"] for _ in range(5)]
        p.set_value("vibrato_speed", 8.0)
        outs += [p.process_block()["out"] for _ in range(2)]
        p.set_value_with_ramp("vibrato_speed", 3.0, 300)
        outs += [p.process_block()["out"] for _ in range(2)]
        return torch.cat(outs), p, dict(add.launches)
    a, pa, la = run(True)
    b, pb, lb = run(False)
    assert torch.equal(a, b)
    assert all(torch.equal(pa.state["tremolo"][k], pb.state["tremolo"][k])
               for k in pb.state["tremolo"])
    # blocks 2-7 steady with a constant rate (K5), 8-9 ramping (K1)
    assert la[add.EPILOGUE] == 6 and la["v4"] == 2
    assert lb[add.EPILOGUE] == 0 and lb["v4"] == 8


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


# ------------------------------------------------------------------ #
# the FM slice: fract_phase3, fm_chain3_scan, pivot_chain3_scan,
# fm_operator_scan
# ------------------------------------------------------------------ #
def _on(cuda, a):
    return torch.as_tensor(np.asarray(a, np.float32), device=cuda)


@pytest.mark.parametrize("V,B", SCAN_SHAPES)
def test_fract_phase3_kernel_equals_plain(cuda, V, B):
    rng = np.random.default_rng(V + B)
    p = _on(cuda, rng.uniform(-1, 1, (3, V)))
    before = kfm.launches["fract_phase3"]
    for _ in range(3):
        dt = _on(cuda, rng.uniform(-0.05, 0.4, (3, V)))
        k = kfm.fract_phase3(p, dt, B)
        torch.cuda.synchronize()
        assert _equal(k, kfm.plain_fract_phase3(p, dt, B))
        p = k[3]
    assert kfm.launches["fract_phase3"] == before + 3


def _chain_args(cuda, rng, V, B, per_sample, fb):
    """Per-sample dt steps the pitch mid-block (a note-on); levels,
    feedbacks and route per voice."""
    f = rng.uniform(100, 1000, V)
    freq = np.broadcast_to(f, (B, V)).copy()
    if per_sample:
        freq[B // 3:, ::2] *= 1.5
    dt = np.stack([freq * r / 48000.0 for r in (3.0, 2.0, 1.0)])
    if not per_sample:
        dt = dt[:, :1]
    return [_on(cuda, x) for x in (
        dt, rng.uniform(0.3, 1.0, (3, V)), fb * rng.uniform(0, 1, (3, V)),
        rng.uniform(0, 1, V), *[rng.uniform(0.1, 1.0, (B, V))
                                for _ in range(3)])]


# the chains' operators run 2 samples apart (csrc/fm.cu): blocks shorter
# than the skew, around the ring's 32-step chunk, the main path's; V=256
# with per-sample dt stages 6 planes (72 KB of ring)
CHAIN_SHAPES = sorted(set(SCAN_SHAPES) | {
    (V, B) for V in (1, 3, 33, 256) for B in (1, 2, 3, 33, 1024)})


@pytest.mark.parametrize("fb", [0.0, 0.4], ids=["fb0", "fb"])
@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["const_dt", "per_sample_dt"])
@pytest.mark.parametrize("V,B", CHAIN_SHAPES)
@pytest.mark.parametrize("chain", ["fm", "pivot"])
def test_chain_kernel_equals_plain(cuda, chain, V, B, per_sample, fb):
    """3 chained blocks, every output and carry bit for bit; with fb 0.4
    every operator has feedback."""
    scan = getattr(kfm, f"{chain}_chain3_scan")
    plain = getattr(kfm, f"plain_{chain}_chain3_scan")
    name = f"{chain}_chain3_scan"
    rng = np.random.default_rng(V * B + per_sample)
    carry = (_on(cuda, rng.uniform(0, 1, (3, V))),
             _on(cuda, rng.normal(size=(3, V))))
    before = kfm.launches[name]
    for _ in range(3):
        args = _chain_args(cuda, rng, V, B, per_sample, fb)
        k = scan(*carry, *args)
        torch.cuda.synchronize()
        assert _equal(k, plain(*carry, *args))
        carry = k[1:]
    assert kfm.launches[name] == before + 3


@pytest.mark.parametrize("V,B", [(3, 64), (40, 128), (256, 1024)])
@pytest.mark.parametrize("chain", ["fm", "pivot"])
def test_zero_feedback_branch_equals_chain_kernel(cuda, chain, V, B):
    """On the card the zero-feedback branch (fract_phase3 and plain
    PyTorch) and the sequential chain kernel are bit-equal too."""
    scan = getattr(kfm, f"{chain}_chain3_scan")
    rng = np.random.default_rng(V + B)
    fast = seq = (_on(cuda, rng.uniform(0, 1, (3, V))),
                  _on(cuda, rng.normal(size=(3, V))))
    before = dict(kfm.launches)
    for _ in range(3):
        args = _chain_args(cuda, rng, V, B, False, 0.0)
        f = scan(*fast, *args, fb_zero=True)
        s_ = scan(*seq, *args)
        torch.cuda.synchronize()
        assert _equal(f, s_)
        fast, seq = f[1:], s_[1:]
    assert kfm.launches["fract_phase3"] == before["fract_phase3"] + 3
    assert kfm.launches[f"{chain}_chain3_scan"] == \
        before[f"{chain}_chain3_scan"] + 3


@pytest.mark.parametrize("V,B", SCAN_SHAPES)
def test_fm_operator_kernel_equals_plain(cuda, V, B):
    """Per-sample dt, phase modulation, feedback, envelope and level."""
    rng = np.random.default_rng(V * 3 + B)
    carry = (_on(cuda, rng.uniform(0, 1, V)), _on(cuda, rng.normal(size=V)))
    before = kfm.launches["fm_operator_scan"]
    for _ in range(3):
        planes = [_on(cuda, rng.uniform(lo, hi, (B, V))) for lo, hi in (
            (0.002, 0.03), (-0.2, 0.2), (0.0, 0.6), (0.1, 1.0), (0.3, 1.0))]
        k = kfm.fm_operator_scan(*carry, *planes)
        torch.cuda.synchronize()
        assert _equal(k, kfm.plain_fm_operator_scan(*carry, *planes))
        carry = k[1:]
    assert kfm.launches["fm_operator_scan"] == before + 3


# K14 reads its five planes through the staged ring (csrc/scan_stage.cuh)
# and stages y: every B around the 32-step chunk, ragged V
OPERATOR_RING_V = (1, 3, 33, 256)
OPERATOR_RING_B = (1, 2, 31, 32, 33, 65, 1024, 4096)


@pytest.mark.parametrize("V", OPERATOR_RING_V)
def test_fm_operator_ring_equals_plain(cuda, V):
    """3 chained blocks at every B: every output and carry bit for bit, one
    launch a block."""
    for B in OPERATOR_RING_B:
        rng = np.random.default_rng(V * 43 + B)
        carry = (_on(cuda, rng.uniform(0, 1, V)),
                 _on(cuda, rng.normal(size=V)))
        before = kfm.launches["fm_operator_scan"]
        for _ in range(3):
            planes = [_on(cuda, rng.uniform(lo, hi, (B, V))) for lo, hi in (
                (0.002, 0.03), (-0.2, 0.2), (0.0, 0.6), (0.1, 1.0),
                (0.3, 1.0))]
            k = kfm.fm_operator_scan(*carry, *planes)
            torch.cuda.synchronize()
            assert _equal(k, kfm.plain_fm_operator_scan(*carry, *planes)), B
            carry = k[1:]
        assert kfm.launches["fm_operator_scan"] == before + 3, B


def test_fm_wrappers_reject_what_they_do_not_take(cuda):
    z3 = torch.zeros(3, 8, device=cuda)
    env = torch.zeros(16, 8, device=cuda)
    dt = torch.zeros(3, 1, 8, device=cuda)
    row = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="contiguous float32"):
        kfm.fract_phase3(z3, z3.cpu(), 16)
    with pytest.raises(ValueError, match="contiguous"):
        kfm.fm_chain3_scan(torch.zeros(8, 3, device=cuda).t(), z3, dt, z3,
                           z3, row, env, env, env)
    with pytest.raises(ValueError, match="contiguous float32"):
        kfm.pivot_chain3_scan(z3, z3, dt, z3, z3, row.double(), env, env,
                              env)
    with pytest.raises(ValueError, match="contiguous float32"):
        kfm.fm_operator_scan(row, row, env, env, env.cpu(), env, env)


def _fm_model(build, device, voices=16, B=256, fused=True):
    p = build(voices, fused=fused).compile(48000.0, block_size=B,
                                           device=device)
    p.set_value("route", 0.4)
    for i in range(voices):
        p.queue_event("midi_in", 3 * i, raw_midi_event([0x90, 40 + i, 100]))
    outs = [p.process_block()["audio_out"] for _ in range(3)]
    p.queue_event("midi_in", 20, raw_midi_event([0x80, 40, 0]))
    if build is build_pivot:
        p.set_value("op3_feedback", 0.3)
    outs += [p.process_block()["audio_out"] for _ in range(3)]
    return p, torch.cat(outs).cpu()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("model", ["fm_synth", "pivot"])
def test_fm_models_on_card_match_cpu(cuda, model, fused):
    """Event and steady blocks, a note-off and (pivot) live feedback: the
    kernels on the card and the plain versions on the CPU, within 1e-5."""
    build = build_fm_synth if model == "fm_synth" else build_pivot
    kfm.reset_launches()
    p, a = _fm_model(build, "cuda", fused=fused)
    if fused:
        chain = f"{'fm' if model == 'fm_synth' else 'pivot'}_chain3_scan"
        assert kfm.launches[chain] > 0 and kfm.launches["fract_phase3"] > 0
        assert p.state["voices.ops"]["phases"].device.type == "cuda"
    else:
        assert kfm.launches["fm_operator_scan"] == 3 * 6
    _, b = _fm_model(build, "cpu", fused=fused)
    assert float(b.abs().max()) > 0.01
    assert np.abs(a.numpy() - b.numpy()).max() <= 1e-5


# ------------------------------------------------------------------ #
# the twin-peaks slice: lp18_scan, biquad_scan, the filters, the device
# default
# ------------------------------------------------------------------ #
FILTER_SHAPES = [(2, 1024), (2, 4096), (256, 1024), (3, 37), (1, 100)]


def _on(cuda, a):
    return torch.as_tensor(np.asarray(a, np.float32), device=cuda)


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("V,B", FILTER_SHAPES)
def test_lp18_scan_kernel_equals_plain(cuda, V, B, per_sample):
    """3 chained blocks with inputs that saturate the tanh: every output
    bit for bit (float64 tanh rounded once, IEEE division, no FMA)."""
    rng = np.random.default_rng(V + B + per_sample)
    shape = (B, V) if per_sample else (V,)
    z = _on(cuda, rng.uniform(-0.8, 0.8, (3, V)))
    before = kiir.launches["lp18_scan"]
    for _ in range(3):
        x = _on(cuda, 3.0 * rng.standard_normal((B, V)))
        g = _on(cuda, rng.uniform(0.01, 0.9, shape))
        h = _on(cuda, rng.uniform(0.0, 1.98, shape))
        out = kiir.lp18_scan(x, g, h, z)
        torch.cuda.synchronize()
        assert _equal(out, kiir.plain_lp18_scan(x, g, h, z))
        z = out[1]
    assert kiir.launches["lp18_scan"] == before + 3
    assert float(out[0].abs().max()) > 0.1


# K7 and K8 read x and their per-sample planes through a ring of 32-step
# chunks (csrc/scan_stage.cuh): every B around the chunk, ragged V
RING_B = (1, 2, 31, 32, 33, 1024, 4096)
RING_V = (1, 2, 3, 33, 256)


def _twin_g(rng, shape):
    """The twin peaks' g = tan(pi fc), fc in [0.001, 0.33]
    (nodes/filters.py)."""
    return np.tan(np.pi * rng.uniform(0.001, 0.33, shape))


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("V", RING_V)
def test_tpt_svf_ring_equals_plain(cuda, V, per_sample):
    for B in RING_B:
        rng = np.random.default_rng(V * 31 + B + per_sample)
        shape = (B, V) if per_sample else (V,)
        z = [_on(cuda, rng.standard_normal(V)) for _ in range(2)]
        for _ in range(3):
            x = _on(cuda, rng.standard_normal((B, V)))
            h, g, k = (_on(cuda, rng.uniform(0.3, 0.9, shape)),
                       _on(cuda, rng.uniform(0.05, 0.5, shape)),
                       _on(cuda, rng.uniform(1.0, 2.0, shape)))
            out = kiir.tpt_svf_scan(x, h, g, k, *z)
            torch.cuda.synchronize()
            assert _equal(out, kiir.plain_tpt_svf_scan(x, h, g, k, *z)), B
            z = list(out[1:])


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("V", RING_V)
def test_lp18_ring_equals_plain(cuda, V, per_sample):
    """g and h over the twin peaks' ranges, x that saturates the tanh."""
    for B in RING_B:
        rng = np.random.default_rng(V * 37 + B + per_sample)
        shape = (B, V) if per_sample else (V,)
        z = _on(cuda, rng.uniform(-0.8, 0.8, (3, V)))
        for _ in range(3):
            x = _on(cuda, 3.0 * rng.standard_normal((B, V)))
            g = _on(cuda, _twin_g(rng, shape))
            h = _on(cuda, rng.uniform(0.0, 1.98, shape))
            out = kiir.lp18_scan(x, g, h, z)
            torch.cuda.synchronize()
            assert _equal(out, kiir.plain_lp18_scan(x, g, h, z)), B
            z = out[1]


@pytest.mark.parametrize("per_sample", [False, True])
def test_lp18_edge_inputs_equal_plain(cuda, per_sample):
    """Silence from a zero state (a zero numerator), denormal x, x of
    1e20 (past the division's guard at 2^60) and signed zeros, in chained
    blocks."""
    V, B = 4, 1024
    rng = np.random.default_rng(11 + per_sample)
    shape = (B, V) if per_sample else (V,)
    z = torch.zeros(3, V, device=cuda)
    blocks = [np.zeros((B, V)),
              1e-40 * rng.standard_normal((B, V)),
              np.where(rng.uniform(size=(B, V)) < 0.01, 1e20, 0.0)
              * np.sign(rng.standard_normal((B, V))),
              np.full((B, V), -0.0),
              0.5 * rng.standard_normal((B, V))]
    for xb in blocks:
        x = _on(cuda, xb)
        g = _on(cuda, _twin_g(rng, shape))
        h = _on(cuda, rng.uniform(0.0, 1.98, shape))
        out = kiir.lp18_scan(x, g, h, z)
        torch.cuda.synchronize()
        plain = kiir.plain_lp18_scan(x, g, h, z)
        assert _equal(out, plain)
        # the signs of zeros too
        assert all(torch.equal(torch.signbit(a), torch.signbit(b))
                   for a, b in zip(out, plain))
        z = out[1]


def test_tanh_exact_equals_the_float64_tanh_everywhere(cuda):
    """K8's tanh over all 2^32 float32 inputs equals (float)tanh((double)b)
    (NaN equal to NaN); the rounding test leaves the NaNs and about 2 in
    10^6 of the rest undecided."""
    wrong, undecided, first = kiir.tanh_exact_sweep()
    assert wrong == 0, f"first differing input: {first:#010x}"
    nans = 2 * (2 ** 23 - 1)
    assert nans <= undecided <= nans + 2 ** 32 * 1e-4


def test_division_equals_the_ieee_quotient(cuda):
    """K8's division over every finite float32 a and 70 divisors in
    [1, 4]: the twin peaks' 1 + g at its cutoff limits and defaults,
    mantissas of all ones, powers of two, and seeded draws."""
    fc = np.array([0.001, 0.33, 700 / 48000, 1000 / 48000, 2100 / 48000])
    d = np.concatenate([
        1.0 + np.tan(np.pi * fc).astype(np.float32),
        [1.0, 2.0, 4.0, np.nextafter(np.float32(2), np.float32(0)),
         np.nextafter(np.float32(4), np.float32(0)),
         np.nextafter(np.float32(1), np.float32(2))],
        np.random.default_rng(5).uniform(1.0, 4.0, 59)]).astype(np.float32)
    assert len(d) >= 64
    assert kiir.div_sweep(_on(cuda, d)) == 0


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("V,B", FILTER_SHAPES)
def test_biquad_scan_kernel_equals_plain(cuda, V, B, per_sample):
    """3 chained blocks, the input decaying below 1e-15 in the last one, so
    the snaps fire: every output bit for bit; the tail holds exact zeros
    (a lane may keep a ~1e-15 cycle that the snaps themselves sustain, as
    in the reference's tick)."""
    rng = np.random.default_rng(V * B + per_sample)
    shape = (B, V) if per_sample else (V,)
    cut = rng.uniform(1500.0, 8000.0, shape)
    n = 1.0 / np.tan(np.pi * cut / 48000.0)
    c1 = 1.0 / (1.0 + np.sqrt(2.0) * n + n * n)
    coefs = [_on(cuda, c) for c in (c1, 2 * c1, c1, 2 * c1 * (1 - n * n),
                                     c1 * (1 - np.sqrt(2.0) * n + n * n))]
    v = [_on(cuda, rng.standard_normal(V)) for _ in range(2)]
    before = kiir.launches["biquad_scan"]
    for i in range(3):
        x = rng.standard_normal((B, V))
        if i == 2:
            x *= np.exp(-np.arange(B) / 4.0)[:, None]
        x = _on(cuda, x)
        out = kiir.biquad_scan(x, *coefs, *v)
        torch.cuda.synchronize()
        assert _equal(out, kiir.plain_biquad_scan(x, *coefs, *v))
        v = list(out[1:])
    assert kiir.launches["biquad_scan"] == before + 3
    if B >= 1024:
        tail = out[0][-100:]
        assert float(tail.abs().max()) < 1e-14
        assert bool((tail == 0).any())


# K9 reads x and its per-sample planes through the staged ring
# (csrc/scan_stage.cuh): every B around the 32-step chunk and its 8-step
# groups, ragged V; which coefficients are planes (bit i: b0, b1, b2, a1,
# a2; the wrapper expands a mix's rows into planes for the kernel)
BIQUAD_RING_V = (1, 2, 3, 33, 256)
BIQUAD_RING_B = (1, 2, 7, 8, 31, 32, 33, 65, 1024)
BIQUAD_FORMS = {"rows": 0b00000, "planes": 0b11111, "mixed": 0b10110,
                "mixed2": 0b01001}


def _biquad_operands(cuda, rng, V, B, mask):
    """JUCE lowpass coefficients (cutoffs in [1500, 8000] Hz, q =
    1/sqrt(2)) per lane, as rows; where ``mask`` has a plane, each sample's
    coefficients moved by up to 1e-3 of themselves (a stable filter)."""
    cut = rng.uniform(1500.0, 8000.0, V)
    n = 1.0 / np.tan(np.pi * cut / 48000.0)
    c1 = 1.0 / (1.0 + np.sqrt(2.0) * n + n * n)
    rows = (c1, 2 * c1, c1, 2 * c1 * (1 - n * n),
            c1 * (1 - np.sqrt(2.0) * n + n * n))
    return [_on(cuda, r * (1 + 1e-3 * rng.uniform(-1, 1, (B, V)))
                if mask >> i & 1 else r) for i, r in enumerate(rows)]


@pytest.mark.parametrize("form", BIQUAD_FORMS)
@pytest.mark.parametrize("V", BIQUAD_RING_V)
def test_biquad_ring_equals_plain(cuda, V, form):
    """3 chained blocks at every B, the input decaying below 1e-15 in the
    last one (the snaps fire): every output bit for bit, one launch a block
    (mixed row and plane coefficients too)."""
    mask = BIQUAD_FORMS[form]
    for B in BIQUAD_RING_B:
        rng = np.random.default_rng(V * 41 + B + mask)
        v = [_on(cuda, rng.standard_normal(V)) for _ in range(2)]
        before = kiir.launches["biquad_scan"]
        for i in range(3):
            coefs = _biquad_operands(cuda, rng, V, B, mask)
            x = rng.standard_normal((B, V))
            if i == 2:
                x *= np.exp(-np.arange(B) / 4.0)[:, None]
            x = _on(cuda, x)
            out = kiir.biquad_scan(x, *coefs, *v)
            torch.cuda.synchronize()
            assert _equal(out, kiir.plain_biquad_scan(x, *coefs, *v)), B
            v = list(out[1:])
        assert kiir.launches["biquad_scan"] == before + 3, B


def test_biquad_every_stride_mix_runs_the_kernel(cuda):
    """Each of the 32 mixes of row and plane coefficients on CUDA tensors:
    one launch, every output equal to the plain version."""
    V, B = 3, 40
    for mask in range(32):
        rng = np.random.default_rng(mask)
        coefs = _biquad_operands(cuda, rng, V, B, mask)
        x = _on(cuda, rng.standard_normal((B, V)))
        v = [_on(cuda, rng.standard_normal(V)) for _ in range(2)]
        before = kiir.launches["biquad_scan"]
        out = kiir.biquad_scan(x, *coefs, *v)
        torch.cuda.synchronize()
        assert kiir.launches["biquad_scan"] == before + 1, mask
        assert _equal(out, kiir.plain_biquad_scan(x, *coefs, *v)), mask


def test_compile_defaults_to_the_card(cuda):
    """``compile()``, ``CompiledGraph`` and ``state_from_jax`` with no
    device put their state on the card."""
    from oscen_tpu_torch.models.twin_peaks import build_twin_peaks
    from oscen_tpu_torch.utils.convert import state_from_jax
    c = build_twin_peaks().compile(48000.0, block_size=64)
    assert c.device.type == "cuda"
    assert c.state["filters"]["z"].device.type == "cuda"
    assert state_from_jax({"z": np.zeros(3, np.float32)})["z"].device.type \
        == "cuda"


def _twin(device, fused, B):
    """Seeded noise block by block, cutoff_a 640 / resonance 0.8 at block
    3, cutoff_b 2500 at block 5 (tests/test_models_aux.py:187-199)."""
    from oscen_tpu_torch.models.twin_peaks import build_twin_peaks
    x = (np.random.default_rng(1).standard_normal(8 * B) * 0.3).astype(
        np.float32)
    c = build_twin_peaks(fused=fused).compile(48000.0, block_size=B,
                                              device=device)
    ys = []
    for i in range(8):
        if i == 3:
            c.set_value("cutoff_a", 640.0)
            c.set_value("resonance", 0.8)
        if i == 5:
            c.set_value("cutoff_b", 2500.0)
        ys.append(c.process_block(
            stream_inputs={"audio_in": x[i * B:(i + 1) * B]})["audio_out"])
    return c, torch.cat(ys).cpu()


@pytest.mark.parametrize("B", [256, 1024])
def test_twin_peaks_on_card_matches_cpu(cuda, B):
    """One lp18_scan per block fused, two unfused; the card equals the CPU
    and the fused build equals the two-node build, bit for bit."""
    outs = {}
    for fused in (True, False):
        kiir.reset_launches()
        c, outs[fused] = _twin("cuda", fused, B)
        assert kiir.launches["lp18_scan"] == (1 if fused else 2) * 8
        assert c.state["filters" if fused else "filter_a"]["z"].device.type \
            == "cuda"
        assert torch.equal(outs[fused], _twin("cpu", fused, B)[1])
    assert torch.equal(outs[True], outs[False])
    assert float(outs[True].abs().max()) > 0.3


@pytest.mark.parametrize("B", [1024, 33])
def test_iir_lowpass_on_card_matches_cpu(cuda, B):
    """saw -> IirLowpass -> out with a cutoff change mid-run: one
    biquad_scan per block, the card equal to the CPU."""
    from oscen_tpu_torch import Graph, IirLowpass, Oscillator

    def run(device):
        g = Graph("I")
        g.input("cutoff", "value", default=1000.0)
        g.output("out", "stream")
        o = g.add("o", Oscillator.saw(330.0, 0.5))
        f = g.add("f", IirLowpass(1000.0))
        g.connect("cutoff", f.cutoff)
        g.connect(o.output, f.input)
        g.connect(f.output, "out")
        c = g.compile(48000.0, block_size=B, device=device)
        ys = []
        for i in range(6):
            if i == 3:
                c.set_value("cutoff", 2500.0)
            ys.append(c.process_block()["out"])
        return torch.cat(ys).cpu()
    kiir.reset_launches()
    a = run("cuda")
    assert kiir.launches["biquad_scan"] == 6
    b = run("cpu")
    assert float(b.abs().max()) > 0.1
    assert float((a - b).abs().max()) <= 1e-6


# ------------------------------------------------------------------ #
# the echo and saturator slice: allpass_cascade_scan, the resamplers,
# the delay
# ------------------------------------------------------------------ #
# the saturator's shapes, and (K10's stages run 1 sample apart, csrc/
# iir.cu) blocks shorter than the skew and around the ring's 32-step
# chunk, at lane counts from one to full and ragged 32-lane blocks
ALLPASS_SHAPES = sorted(
    {(1, 1024), (2, 2048), (2, 4096), (256, 1024), (3, 37)}
    | {(V, B) for V in (1, 2, 3, 33, 256) for B in (1, 2, 31, 32, 33, 65)})


@pytest.mark.parametrize("S", range(1, 9))
@pytest.mark.parametrize("V,B", ALLPASS_SHAPES)
def test_allpass_cascade_scan_kernel_equals_plain(cuda, V, B, S):
    """3 chained blocks, per-lane betas (at S = 2 the two halfband
    branches side by side, else random): every output bit for bit."""
    from oscen_tpu_torch.ops.resample import BRANCH_A_BETAS, BRANCH_B_BETAS
    rng = np.random.default_rng(V + B + 1000 * S)
    if S == 2:
        betas = np.array([BRANCH_A_BETAS, BRANCH_B_BETAS], np.float32).T
        a = _on(cuda, np.tile(betas, (1, V))[:, :V])
    else:
        a = _on(cuda, rng.uniform(-0.95, 0.95, (S, V)))
    carry = [_on(cuda, rng.uniform(-1, 1, (S, V))) for _ in range(2)]
    before = kiir.launches["allpass_cascade_scan"]
    for _ in range(3):
        x = _on(cuda, rng.standard_normal((B, V)))
        out = kiir.allpass_cascade_scan(x, a, *carry)
        torch.cuda.synchronize()
        assert _equal(out, kiir.plain_allpass_cascade_scan(x, a, *carry))
        carry = list(out[1:])
    assert kiir.launches["allpass_cascade_scan"] == before + 3


def _echo(device, B, n=8):
    """A 0.05 s echo (2400 samples, so the island dissolves at B=1024 and
    echoes return within the run): seeded noise block by block, feedback
    0.6 from block 0, mix 0.8 from block n // 2."""
    from oscen_tpu_torch.models.simple import build_simple_echo
    x = (np.random.default_rng(2).standard_normal(n * B) * 0.3).astype(
        np.float32)
    c = build_simple_echo(0.05).compile(48000.0, block_size=B,
                                        device=device)
    c.set_value("feedback", 0.6)
    ys = []
    for i in range(n):
        if i == n // 2:
            c.set_value("mix", 0.8)
        ys.append(c.process_block(
            stream_inputs={"x": x[i * B:(i + 1) * B]})["out"])
    return c, torch.cat(ys).cpu()


@pytest.mark.parametrize("B", [512, 1024])
def test_echo_on_card_matches_cpu(cuda, B):
    """The dissolved echo: one tpt_svf_scan per block, the delay's ring
    buffer on the card, the card within 1e-6 of the CPU."""
    kiir.reset_launches()
    c, y = _echo("cuda", B)
    assert kiir.launches["tpt_svf_scan"] == 8
    assert c.state["delay"]["buf"].device.type == "cuda"
    assert float((y - _echo("cpu", B)[1]).abs().max()) <= 1e-6
    assert float(y.abs().max()) > 0.3


@pytest.mark.parametrize("policy", ["sinc", "sinc_iir"])
def test_saturator_on_card_matches_cpu(cuda, policy):
    """The 4x saturator: one phase_scan per block over 4B samples, and with
    the IIR boundary two allpass_cascade_scan launches per block (one per
    halfband stage, both branches as lanes); the card within 1e-6 of the
    CPU."""
    from oscen_tpu_torch import Graph, HardClip, PolyBlepOscillator

    def run(device):
        g = Graph("Sat4")
        g.output("audio_out", "stream")
        osc = g.add("osc", PolyBlepOscillator.saw(2000.0, 0.6), rate=4)
        clip = g.add("clip", HardClip(), rate=4)
        g.connect(osc.output, clip.input)
        g.connect(clip.output, "audio_out", policy=policy)
        c = g.compile(48000.0, block_size=1024, device=device)
        return c, torch.cat([c.process_block()["audio_out"]
                             for _ in range(4)]).cpu()
    kiir.reset_launches()
    kphase.reset_launches()
    c, y = run("cuda")
    assert kphase.launches["phase_scan"] == 4
    assert kiir.launches["allpass_cascade_scan"] == \
        (8 if policy == "sinc_iir" else 0)
    from oscen_tpu_torch.graph.node import tree_map
    leaves = []
    tree_map(leaves.append, c.state["__rs__"])
    assert all(t.device.type == "cuda" for t in leaves)
    assert float((y - run("cpu")[1]).abs().max()) <= 1e-6
    assert float(y.abs().max()) > 0.5


@pytest.mark.parametrize("delay,min_delay,B", [(150.0, 64, 256),
                                               (77.25, 40, 128)],
                         ids=["integer", "fractional"])
def test_chunked_delay_on_card_matches_cpu(cuda, delay, min_delay, B):
    """The chunked delay (the interpolating read, a gather per chunk, an
    out-of-place scatter) with feedback 0.6 and its parameters live from
    graph inputs: the card equal to the CPU within 1e-6."""
    from oscen_tpu_torch import Delay, Graph

    def run(device):
        g = Graph("D")
        g.input("x", "stream")
        g.input("fb", "value", default=0.6)
        g.input("dly", "value", default=delay)
        g.output("out", "stream")
        d = g.add("d", Delay(delay, 0.0, min_delay=min_delay))
        g.connect("x", d.input)
        g.connect("fb", d.feedback)
        g.connect("dly", d.delay_samples)
        g.connect(d.output, "out")
        c = g.compile(48000.0, block_size=B, device=device)
        c.set_value("dly", delay + 3.5)
        x = np.random.default_rng(7).standard_normal(4 * B).astype(
            np.float32)
        y = c.render_mono(4 * B, stream_inputs={"x": x})
        assert c.state["d"]["buf"].device.type == device
        return y
    y = run("cuda")
    assert np.abs(y - run("cpu")).max() <= 1e-6
    assert np.abs(y).max() > 0.5


def _chain_synth_echo(device, B=512, n=6, on_card=True):
    """The README synth (mono) into the echo's ``x`` block by block; with
    ``on_card`` each synth block goes in as the tensor the synth returned
    (every block after the first under sync debug mode "error" on the
    card), else as numpy."""
    from oscen_tpu_torch.models.simple import (build_simple_echo,
                                               build_simple_synth)
    synth = build_simple_synth().compile(48000.0, block_size=B,
                                         device=device)
    echo = build_simple_echo(0.05).compile(48000.0, block_size=B,
                                           device=device)
    echo.set_value("feedback", 0.5)
    ys = []
    for i in range(n):
        card = device == "cuda" and i > 0 and on_card
        if card:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            x = synth.process_block()["out"]
            if not on_card:
                x = x.cpu().numpy()
            ys.append(echo.process_block(stream_inputs={"x": x})["out"])
        finally:
            if card:
                torch.cuda.set_sync_debug_mode("default")
    return torch.cat(ys)


def test_synth_into_echo_through_card_tensors(cuda):
    """A stream input already on the card is staged without a host copy
    (no sync in any block after the first) and gives the numpy-fed chain
    bit for bit."""
    a = _chain_synth_echo("cuda")
    b = _chain_synth_echo("cuda", on_card=False)
    assert torch.equal(a, b)
    assert float(a.abs().max()) > 0.1


# ------------------------------------------------------------------ #
# K16 / K17: the ablation kernels against their plain versions
# ------------------------------------------------------------------ #
from oscen_tpu_torch.ops.cuda import fractabl as kfa  # noqa: E402
from oscen_tpu_torch.ops.cuda import kabl as kab  # noqa: E402

KABL_CASES = [(t, v) for t, vs in kab.TOOLS.items() for v in vs]


def _tool_inputs(cuda, tool, B=1024):
    import importlib
    x = importlib.import_module(f"oscen_tpu_torch.tools.{tool}").inputs(B)
    x = {k: torch.as_tensor(v, device=cuda) for k, v in x.items()}
    if "tbl" in x:   # a random table, so that the one-hot rows are not 0
        rng = np.random.default_rng(B)
        x["tbl"] = torch.as_tensor(rng.uniform(0, 0.5, tuple(x["tbl"].shape))
                                   .astype(np.float32), device=cuda
                                   ).to(torch.bfloat16)
    return x


@pytest.mark.parametrize("tool,variant", KABL_CASES)
def test_kabl_kernel_matches_plain(cuda, tool, variant):
    """Every K16 variant at its tool's full width (H=32, V=256, B=1024),
    2 chained blocks: every state plane torch.equal to the plain version,
    y within ``kabl.y_bound``; exactly one launch of its kernel."""
    x = _tool_inputs(cuda, tool)
    body = kab.TOOLS[tool][variant].body
    counters = add.launches if body in ("k3", "k1") else kab.launches
    before = sum(counters.values())
    for _ in range(2):
        out = kab.run_variant(tool, variant, x, 1024)
        torch.cuda.synchronize()
        plain = kab.run_variant(tool, variant, x, 1024, plain=True)
        err = float((out[0] - plain[0]).abs().max())
        assert err <= kab.y_bound(tool, variant, plain[0], 256), err
        for a, b in zip(out[1:], plain[1:]):
            assert torch.equal(a, b)
        x = dict(x, osc_re=out[1], osc_im=out[2], cur=out[3], tgt=out[4],
                 step=out[5])
    assert sum(counters.values()) == before + 2


@pytest.mark.parametrize("V,B", [(256, 1024), (256, 4096), (6, 40)])
@pytest.mark.parametrize("layout", kfa.LAYOUTS)
def test_fract_layout_kernel_equals_k12(cuda, layout, V, B):
    """Every output of every K17 layout torch.equal to K12 (fract_phase3's
    kernel) and to its plain version, 2 chained blocks."""
    rng = np.random.default_rng(V + B)
    p = torch.as_tensor(rng.uniform(-1, 1, (3, V)).astype(np.float32),
                        device=cuda)
    before = kfa.launches[kfa.KERNEL]
    for _ in range(2):
        dt = torch.as_tensor(rng.uniform(-0.05, 0.4, (3, V))
                             .astype(np.float32), device=cuda)
        got = kfa.fract_layout(layout, p, dt, B)
        k12 = kfm.fract_phase3(p, dt, B)
        raw, _ = kfa.PLAIN[layout](p, dt, B)
        torch.cuda.synchronize()
        for a, b, c in zip(got, k12, (*kfa.planes(layout, raw), got[3])):
            assert torch.equal(a, b) and torch.equal(a, c)
        p = got[3]
    assert kfa.launches[kfa.KERNEL] == before + 2


def test_ablation_wrappers_reject_what_they_do_not_take(cuda):
    x = _tool_inputs(cuda, "kabl4", B=64)
    planes = [x[k] for k in kab.PLANES]
    with pytest.raises(ValueError, match="harmonics"):
        kab.kabl_block("full", *[t[:8].contiguous() for t in planes],
                       x["step"], 64)
    with pytest.raises(ValueError, match="float32"):
        kab.kabl_block("full", *planes[:-1], planes[-1].double(),
                       x["step"], 64)
    with pytest.raises(ValueError, match="float32"):
        kfa.fract_layout("direct", torch.zeros(3, 8, device=cuda,
                                               dtype=torch.float64),
                         torch.zeros(3, 8, device=cuda,
                                     dtype=torch.float64), 8)


# ------------------------------------------------------------------ #
# K6 on its staged ring with the short exact wrap; K1's time segments
# ------------------------------------------------------------------ #
PHASE_RING_B = (1, 31, 33, 1024, 4096, 16384)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same_bits(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("edges", [False, True], ids=["main", "edges"])
@pytest.mark.parametrize("V", RING_V)
def test_phase_ring_equals_plain(cuda, V, edges):
    """Every B around the ring's chunk up to the 4x saturator's 16384
    steps, 3 chained blocks, bit patterns of every output; the edge dt
    (-0, denormals, negatives, >= 1, +-inf, NaN) re-run their chunks with
    floor, the main paths' dt in (0, 0.5) re-run none."""
    f32 = np.float32
    e = np.array([-0.0, 1e-40, -1e-40, np.nextafter(f32(1), f32(0)), 1.0,
                  1.5, 2.0, -0.25, -3.5, 7.0, np.inf, -np.inf, np.nan], f32)
    kphase.take_reruns(cuda)
    for B in PHASE_RING_B:
        rng = np.random.default_rng(V * 53 + B + edges)
        p0 = rng.uniform(0, 1, V).astype(np.float32)
        if edges:
            p0[0] = -0.0
        p = _on(cuda, p0)
        for _ in range(3):
            dt = rng.uniform(0.0, 0.5, (B, V)).astype(np.float32)
            if edges:
                idx = rng.integers(0, B * V, min(B * V, 48))
                dt.reshape(-1)[idx] = rng.choice(e, len(idx))
            dt = _on(cuda, dt)
            out = kphase.phase_scan(p, dt)
            torch.cuda.synchronize()
            plain = kphase.plain_phase_scan(p, dt)
            assert _same_bits(out, plain), B
            p = out[1]
    assert (kphase.take_reruns(cuda) > 0) == edges


@pytest.mark.parametrize("V,B", [(256, 1024), (256, 4096), (1, 4096),
                                 (3, 100)])
def test_phase_bodies_equal_plain(cuda, V, B):
    """Both ways of storing `before` (the chain warp's stores for 32
    lanes, the producer's write-back for fewer) at the main paths' shapes,
    with no chunk re-run."""
    rng = np.random.default_rng(V + B)
    p = _on(cuda, rng.uniform(0, 1, V))
    dt = _on(cuda, rng.uniform(0.001, 0.5, (B, V)))
    plain = kphase.plain_phase_scan(p, dt)
    kphase.take_reruns(cuda)
    got = kphase.phase_scan(p, dt)
    torch.cuda.synchronize()
    assert _same_bits(got, plain)
    assert kphase.take_reruns(cuda) == 0


@pytest.mark.parametrize("B", [1024, 4096])
@pytest.mark.parametrize("lanes", ["on", "off", "mixed"])
def test_fract_phase3_lanes_equal_plain(cuda, lanes, B):
    """K12 on the models' lanes (p0 in [0, 1), dt in (0, 0.5): the short
    wrap), on lanes off it (p0 below 0, edge dt: -0.0, a denormal, 1.0,
    +-inf, NaN) and on warps of both, 3 chained blocks: every output equal
    to the plain version on its bit patterns."""
    f32 = np.float32
    edges = np.array([-0.0, -1e-45, 1e-45, 1.0, np.nextafter(f32(1), f32(0)),
                      2.5, np.inf, -np.inf, np.nan], f32)
    rng = np.random.default_rng(B)
    p = rng.uniform(0, 1, (3, 256)).astype(f32)
    if lanes != "on":
        p[:, 1::2] *= -1
        if lanes == "off":
            p[:, 0::2] *= -1
        p[0, 1:2 * len(edges):2] = edges
    p = _on(cuda, p)
    before = kfm.launches["fract_phase3"]
    for _ in range(3):
        dt = rng.uniform(0.001, 0.5, (3, 256)).astype(f32)
        if lanes != "on":
            dt[1, 1:2 * len(edges):2] = edges
        dt = _on(cuda, dt)
        k = kfm.fract_phase3(p, dt, B)
        torch.cuda.synchronize()
        assert _same_bits(k, kfm.plain_fract_phase3(p, dt, B))
        p = k[3]
    assert kfm.launches["fract_phase3"] == before + 3


def test_fract_wrap_equals_trunc_everywhere(cuda):
    """K12's short wrap over all 2^32 float32 q against q - truncf(q), bit
    patterns (NaN equal only to itself); it takes exactly [+0, 2)."""
    wrong, taken = kfm.wrap_sweep()
    assert wrong == 0
    assert taken == 2 ** 30


def test_phase_wrap_equals_floor_everywhere(cuda):
    """The short wrap over all 2^32 float32 q against q - floorf(q), bit
    patterns (NaN equal only to itself); it takes exactly [+0, 2)."""
    wrong, taken = kphase.wrap_sweep()
    assert wrong == 0
    assert taken == 2 ** 30


@pytest.mark.parametrize("version", ["v4", "v3", "v2", "parity"])
@pytest.mark.parametrize("V", [1, 3, 33, 256, 257])
def test_additive_segments_match_plain(cuda, version, V):
    """Every kernel with every segment count at B from one subgroup (or
    parity's harmonic-sum chunk) up: y within the bounds, state planes
    torch.equal, every count's outputs equal."""
    planes_np, step_np = _inputs(V, seed=V)
    planes = [torch.as_tensor(p, device=cuda) for p in planes_np]
    s = torch.as_tensor(step_np, device=cuda)
    for B in (64, 128, 1024, 4096):
        sub = add.subgroup_len(B, version)
        for with_mix in (False, True):
            k_out = add.additive_voice_block(*planes, s, B,
                                             with_mix=with_mix,
                                             version=version)
            torch.cuda.synchronize()
            p_out = add.plain_block(*planes, s, B, with_mix, version)
            tol = 5e-5 * (math.sqrt(V) if with_mix else 1.0)
            assert float((k_out[0] - p_out[0]).abs().max()) <= tol
            assert _equal(k_out[1:], p_out[1:])
            for S in (1, 2, 4):
                if (B // sub) % S == 0:
                    got = add.block_segments(*planes, s, B, S,
                                             with_mix, version)
                    torch.cuda.synchronize()
                    assert _equal(got, k_out), (B, S, with_mix)


def test_segment_choice(cuda):
    """4 segments as far as they divide the subgroups and their tickets
    fit 8-bit fields (~8k voices at 2 warps a block); then 2, then 1."""
    assert add.segments(256, 1024, 64) == 4
    assert add.segments(256, 4096, 64) == 4
    assert add.segments(256, 64, 64) == 1      # B <= SUB
    assert add.segments(256, 128, 64) == 2
    assert add.segments(3, 40, 8) == 1          # 5 subgroups
    assert add.segments(2048, 1024, 64) == 4
    assert add.segments(8160, 1024, 64) == 4    # 255 groups of 16 blocks
    assert add.segments(8161, 1024, 64) == 2


def test_parity_segment_choice(cuda):
    """The parity kernel asks segments() with its 32-sample chunks: 4 at
    the piano's B=1024 and 4096, 2 for 2 chunks, 1 for an odd count."""
    assert add.segments(256, 1024, add.subgroup_len(1024, "parity")) == 4
    assert add.segments(256, 4096, add.subgroup_len(4096, "parity")) == 4
    assert add.segments(256, 64, add.subgroup_len(64, "parity")) == 2
    assert add.segments(256, 96, add.subgroup_len(96, "parity")) == 1
    assert add.segments(3, 40, add.subgroup_len(40, "parity")) == 1


def test_parity_segments_refuse_tickets_that_overflow(cuda):
    """As the closed-form kernels: 4 parity segments of 8161 voices with
    the mix would overflow an 8-bit ticket field and are refused; 2 run and
    equal the kernel's own choice."""
    V, B = 8161, 256
    planes_np, step_np = _inputs(V, seed=1)
    planes = [torch.as_tensor(p, device=cuda) for p in planes_np]
    s = torch.as_tensor(step_np, device=cuda)
    with pytest.raises(RuntimeError, match="invalid argument"):
        add.block_segments(*planes, s, B, 4, True, "parity")
    got = add.block_segments(*planes, s, B, 2, True, "parity")
    want = add.additive_voice_block(*planes, s, B, with_mix=True,
                                    version="parity")
    torch.cuda.synchronize()
    assert _equal(got, want)


def test_segments_refuse_tickets_that_overflow(cuda):
    """With the mix, 4 segments of 8161 voices (256 groups) would overflow
    an 8-bit ticket field: the explicit-count entry refuses them; 2 run."""
    V, B = 8161, 256
    planes_np, step_np = _inputs(V, seed=1)
    planes = [torch.as_tensor(p, device=cuda) for p in planes_np]
    s = torch.as_tensor(step_np, device=cuda)
    with pytest.raises(RuntimeError, match="invalid argument"):
        add.block_segments(*planes, s, B, 4, True)
    got = add.block_segments(*planes, s, B, 2, True)
    want = add.additive_voice_block(*planes, s, B, with_mix=True)
    torch.cuda.synchronize()
    assert _equal(got, want)


# entry steps the envelope never produces and the cycle's edges (as
# tests/test_torch_additive_segments.py): a fraction off, below 0, above
# 64, a +1 that rounds to an integer, the float below 64, stuck counters
# (s + 1 == s), inf and NaN
ODD_STEPS = (0.5, 64.5, 70.0, -3.0, -0.0, 1e-10, -1e-10, -2.5,
             float(np.nextafter(np.float32(64), np.float32(0))), 64.0, 65.0,
             1e-40, 2.0 ** 24, -2.0 ** 25, -1e9, float("nan"), float("inf"),
             float("-inf"))


def _same_nan(a, b):
    """torch.equal on every output, with NaN equal to NaN."""
    def eq(x, y):
        nx, ny = torch.isnan(x), torch.isnan(y)
        return torch.equal(nx, ny) and torch.equal(x[~nx], y[~ny])
    return all(eq(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("version", ["v4", "v3", "v2", "parity"])
@pytest.mark.parametrize("B", [1024, 4096])
def test_additive_segments_entry_steps_outside_0_64(cuda, version, B):
    """Entry steps the envelope never produces (``ODD_STEPS``): every
    segment count still equals one warp per voice, bit for bit (NaN equal
    to NaN), with and without the mix; the state planes equal the plain
    version's, and each voice whose plain rows are finite has its rows
    within 5e-5 of its largest |y| (at least 1: the 2^24 step's first
    tick reaches ~1e6)."""
    planes_np, _ = _inputs(len(ODD_STEPS), seed=3)
    planes = [torch.as_tensor(p, device=cuda) for p in planes_np]
    s = torch.tensor(ODD_STEPS, dtype=torch.float32, device=cuda)
    for with_mix in (False, True):
        one = add.block_segments(*planes, s, B, 1, with_mix, version)
        for S in (2, 4):
            got = add.block_segments(*planes, s, B, S, with_mix,
                                     version)
            torch.cuda.synchronize()
            assert _same_nan(got, one), (S, with_mix)
    got = add.additive_voice_block(*planes, s, B, version=version)
    want = add.plain_block(*planes, s, B, False, version)
    torch.cuda.synchronize()
    assert _same_nan(got[1:], want[1:])
    fin = torch.isfinite(want[0]).all(dim=0)
    assert int(fin.sum()) >= 12
    y, yp = got[0][:, fin], want[0][:, fin]
    scale = yp.abs().amax(dim=0).clamp(min=1.0)
    assert bool(((y - yp).abs() <= 5e-5 * scale).all())


@pytest.mark.parametrize("B", [1024, 4096])
def test_parity_segments_far_negative_steps(cuda, B):
    """K2's replay walks a step below 0 8 ticks at a time with the blend
    alone while s + 8 < 0: steps that reach the cycle late (-1000, -100.5,
    -9, -8.5, -7.5) or never (-2^24 - 2, -2^25, -inf), with and without
    the mix, 2 and 4 segments equal to one warp per voice and the state
    to the plain version's, NaN equal to NaN."""
    steps = (-1000.0, -100.5, -9.0, -8.5, -7.5, -2.0 ** 24 - 2, -2.0 ** 25,
             float("-inf"))
    planes_np, step_np = _inputs(64, seed=9)
    step_np[3:3 + len(steps)] = steps
    planes = [torch.as_tensor(p, device=cuda) for p in planes_np]
    s = torch.as_tensor(step_np, device=cuda)
    for with_mix in (False, True):
        one = add.block_segments(*planes, s, B, 1, with_mix, "parity")
        for S in (2, 4):
            got = add.block_segments(*planes, s, B, S, with_mix, "parity")
            torch.cuda.synchronize()
            assert _same_nan(got, one), (S, with_mix)
    want = add.plain_block(*planes, s, B, False, "parity")
    assert _same_nan(one[1:], want[1:])


@pytest.mark.parametrize("version", add.KERNELS)
def test_piano_steady_blocks_never_wait_for_the_card(cuda, version,
                                                     monkeypatch):
    """After the chord's block, steady piano blocks run under sync debug
    mode "error": no host copy or read of the card inside a block."""
    monkeypatch.setenv("OSCEN_ADDITIVE_KERNEL", version)
    p = build_electric_piano(16).compile(48000.0, block_size=256,
                                         mode="block", device="cuda")
    for n in range(16):
        p.queue_event("midi_in", 0, raw_midi_event([0x90, 40 + n, 100]))
    p.process_block()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [p.process_block()["out"] for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(o.device.type == "cuda" for o in outs)


# ------------------------------------------------------------------ #
# assets: the reverb, the sampler and scope, checkpoints, the host
# ------------------------------------------------------------------ #
def _reverb(device, B=256, cap=4096):
    from oscen_tpu_torch import Convolver, Graph
    g = Graph("Reverb")
    g.input("x", "stream", channels=2)
    g.output("out", "stream", channels=2)
    g.external("ir")
    cv = g.add("conv", Convolver(max_ir_len=cap, channels=2))
    g.connect("ir", cv.ir)
    g.connect("x", cv.input)
    g.connect(cv.output, "out")
    return g.compile(48000.0, block_size=B, device=device)


def _ir(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * np.exp(-np.arange(n) / 2000.0)
            * 0.05).astype(np.float32)


def _reverb_run(c, x, B=256):
    """A publish, 6 blocks, a growth swap (4096 -> 8192 taps), 6 blocks:
    on the card every block after the first, the swap too, under sync
    debug mode "error"."""
    from oscen_tpu_torch import AudioAsset
    on_card = c.device.type == "cuda"
    c.publish_asset("ir", AudioAsset.from_samples(_ir(0, 3000), 48000))
    ys = []
    for i in range(12):
        if on_card and i == 1:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            if i == 6:
                c.publish_asset("ir", AudioAsset.from_samples(_ir(1, 6000),
                                                              48000))
            ys.append(c.process_block(stream_inputs={
                "x": x[i * B:(i + 1) * B]})["out"])
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
    return torch.cat(ys).cpu()


def test_reverb_never_waits_and_matches_the_cpu(cuda):
    """Steady blocks, a publish and its fade never wait for the card; the
    card equals the CPU within 1e-5 x the peak; one rFFT and one irFFT a
    block after the fade."""
    from oscen_tpu_torch.ops import conv
    x = np.random.default_rng(0).uniform(-1, 1, (12 * 256, 2)).astype(
        np.float32)
    card = _reverb_run(_reverb("cuda"), torch.as_tensor(x, device=cuda))
    cpu = _reverb_run(_reverb("cpu"), x)
    peak = float(cpu.abs().max())
    assert float((card - cpu).abs().max()) <= 1e-5 * peak
    c = _reverb("cuda")
    _reverb_run(c, torch.as_tensor(x, device=cuda))
    conv.reset_launches()
    c.process_block(stream_inputs={"x": torch.as_tensor(x[:256],
                                                        device=cuda)})
    assert conv.launches == {"rfft": 1, "irfft": 1}


def test_sampler_filter_scope_card_matches_cpu(cuda):
    from oscen_tpu_torch import (AudioAsset, Graph, Oscilloscope,
                                 SamplePlayer, TptFilter)

    def run(device):
        g = Graph("Sampler")
        g.output("out", "stream")
        g.external("buf")
        sp = g.add("sp", SamplePlayer(capacity=1 << 14))
        f = g.add("f", TptFilter(1200.0, 0.707))
        sc = g.add("sc", Oscilloscope(capacity=512))
        g.connect("buf", sp.buf)
        g.connect(sp.output, f.input)
        g.connect(f.output, sc.input)
        g.connect(sc.output, "out")
        c = g.compile(48000.0, block_size=256, device=device)
        data = np.random.default_rng(1).uniform(-1, 1, (2, 5000)).astype(
            np.float32)
        c.publish_asset("buf", AudioAsset.from_samples(data, 44100))
        ys = [c.process_block()["out"] for _ in range(8)]
        return torch.cat(ys).cpu(), Oscilloscope.snapshot(
            c.node_state("sc"))
    (yc, sc), (yh, sh) = run("cuda"), run("cpu")
    assert float((yc - yh).abs().max()) <= 1e-6
    np.testing.assert_allclose(sc, sh, atol=1e-6, rtol=0)


def test_reverb_checkpoint_and_bundle_resume_on_the_card(cuda, tmp_path):
    from oscen_tpu_torch import AudioAsset
    from oscen_tpu_torch.utils.bundle import load_bundle, save_bundle
    from oscen_tpu_torch.utils.checkpoint import load_state, save_state
    x = torch.as_tensor(np.random.default_rng(2).uniform(
        -1, 1, (8 * 256, 2)).astype(np.float32), device=cuda)
    c = _reverb("cuda")
    c.publish_asset("ir", AudioAsset.from_samples(_ir(0, 3000), 48000))
    for i in range(2):
        c.process_block(stream_inputs={"x": x[i * 256:(i + 1) * 256]})
    c.publish_asset("ir", AudioAsset.from_samples(_ir(1, 4000), 48000))
    c.process_block(stream_inputs={"x": x[512:768]})   # mid-fade
    save_state(c, str(tmp_path / "c.pkl"))
    save_bundle(c, str(tmp_path / "b"))
    fresh = _reverb("cuda")
    load_state(fresh, str(tmp_path / "c.pkl"))
    loaded = load_bundle(str(tmp_path / "b"))
    assert fresh._mirrors == loaded._mirrors == {"conv": {"fade_pos": 256}}
    outs = [torch.cat([g.process_block(stream_inputs={
        "x": x[i * 256:(i + 1) * 256]})["out"] for i in range(3, 8)])
        for g in (c, fresh, loaded)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_streaming_host_keeps_up_on_the_card(cuda):
    """tests/test_streaming_host.py's real-time claims, on the card: a
    block's submit-to-ready time (unpipelined) and the throughput beat the
    block period, and with real-time pacing few deadlines are missed."""
    from oscen_tpu_torch.models.poly_synth import build_poly_synth
    from oscen_tpu_torch.utils.host import StreamingHost
    synth = build_poly_synth(4).compile(48000.0, block_size=512,
                                        device="cuda")
    synth.queue_event("midi_in", 0, raw_midi_event([0x90, 60, 100]))
    synth.process_block()
    synth.process_block()
    fast = StreamingHost(synth, realtime=False, pipeline_depth=0)
    audio = fast.run(0.5)
    r = fast.report()
    assert r["sustained_rtf"] > 1.0 and r["throughput_rtf"] > 1.0, r
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0.01
    paced = StreamingHost(synth, realtime=True)
    paced.run(0.5, collect=False)
    r = paced.report()
    assert r["deadline_misses"] <= r["blocks"] // 4, r


# ------------------------------------------------------------------ #
# voice-capacity classes, the state setter and the examples
# ------------------------------------------------------------------ #
def _class_schedule(vc, blocks=16, sync_check=False):
    """Ten notes struck and released, a down-switch, two notes, eight more
    (an up-switch); a note-off of an unheld key on every block runs the
    prepass.  From the second block on, with ``sync_check``, every block
    and every switch runs under sync debug mode "error"."""
    outs, caps = [], []
    for i in range(blocks):
        evs = []
        if i == 0:
            evs = [[0x90, 50 + j, 100] for j in range(10)]
        elif i == 1:
            evs = [[0x80, 50 + j, 0] for j in range(10)]
        elif i == 8:
            evs = [[0x90, 70 + j, 100] for j in range(2)]
        elif i == 11:
            evs = [[0x90, 80 + j, 100] for j in range(8)]
        for e in evs:
            vc.queue_event("midi_in", 0, raw_midi_event(e))
        vc.queue_event("midi_in", 0, raw_midi_event([0x80, 20, 0]))
        on = sync_check and i > 0
        if on:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            outs.append(vc.process_block()["out"])
        finally:
            if on:
                torch.cuda.set_sync_debug_mode("default")
        caps.append(vc.active_cap)
    return torch.cat(outs).cpu().numpy(), caps


def test_voice_classes_on_card_match_cpu(cuda):
    """The class host on the card against the same on the CPU: the same
    switches, the piano's card-vs-CPU bound (1e-4), K1 at both classes."""
    from oscen_tpu_torch.utils.voice_classes import VoiceClassHost
    kw = dict(capacities=(4, 16), block_size=256, tail_seconds=0.02)
    add.reset_launches()
    card = VoiceClassHost(build_electric_piano, device="cuda", **kw)
    a, caps_a = _class_schedule(card)
    k1 = add.launches["v4"]
    b, caps_b = _class_schedule(VoiceClassHost(build_electric_piano,
                                               device="cpu", **kw))
    assert caps_a == caps_b and 4 in caps_a and card.switches >= 2
    assert k1 > 0
    assert np.abs(b).max() > 1.0
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def test_voice_class_switches_never_wait_for_the_card(cuda):
    """Every block after the first, the switches' permutations and state
    moves included, under sync debug mode "error"."""
    from oscen_tpu_torch.utils.voice_classes import VoiceClassHost
    vc = VoiceClassHost(build_electric_piano, capacities=(4, 16),
                        block_size=256, tail_seconds=0.02, device="cuda")
    _, caps = _class_schedule(vc, sync_check=True)
    assert vc.switches >= 2 and caps[-1] == 16


def test_state_setter_takes_numpy_without_waiting(cuda):
    """A state of numpy leaves goes to the card from pinned memory without
    a wait, and the graph resumes bit for bit."""
    from oscen_tpu_torch.graph.node import tree_map
    from oscen_tpu_torch.models.simple import build_simple_synth
    c = build_simple_synth().compile(48000.0, block_size=256,
                                     device="cuda")
    c.render_mono(512)
    saved = tree_map(lambda x: x.cpu().numpy(), c.state)
    a = c.render_mono(512)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        c.state = saved
    finally:
        torch.cuda.set_sync_debug_mode("default")
    np.testing.assert_array_equal(c.render_mono(512), a)


@pytest.mark.parametrize("name", [
    "electric_piano_demo", "fm_synth_demo", "pivot_demo",
    "oversampled_saturator", "render_convolution", "simple_synth",
    "streaming_host_demo"])
def test_examples_on_card_match_cpu(cuda, name, tmp_path):
    """Each example for 0.05 s on the card and on the CPU: the piano at
    1e-4, the FM models at 1e-5, the rest at 1e-6 x the peak (PERF.md
    section 2)."""
    import importlib
    ex = importlib.import_module(f"oscen_tpu_torch.examples.{name}")
    outs = {}
    for dev in ("cuda", "cpu"):
        if name == "streaming_host_demo":
            argv = ["0.05", "--out", str(tmp_path / f"{dev}.wav")]
        elif name == "render_convolution":
            argv = ["", str(tmp_path / f"{dev}.wav"), "--seconds", "0.025",
                    "--tail", "0.025"]
        else:
            argv = [str(tmp_path / dev), "--seconds", "0.05"]
        outs[dev] = ex.main(argv + ["--device", dev])
    peak = float(np.abs(outs["cpu"]).max())
    tol = {"electric_piano_demo": 1e-4, "fm_synth_demo": 1e-5,
           "pivot_demo": 1e-5}.get(name, 1e-6 * max(peak, 1.0))
    assert peak > 0.01
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], atol=tol, rtol=0)
