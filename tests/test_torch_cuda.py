"""oscen_tpu_torch on a CUDA card: each kernel against its plain PyTorch
version, and the electric-piano slice on the card against the CPU.

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
from oscen_tpu_torch.ops.cuda import additive as add

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
