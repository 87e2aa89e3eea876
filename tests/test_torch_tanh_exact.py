"""K8's short paths on the CPU: the coefficient table of ``tanh_exact``
(``csrc/tanh_table.cuh``) against its generator, its numpy model against
``fmath.tanh`` (the float64 ``tanh`` rounded once), and the build key of
the CUDA sources.  No card and no ``nvcc``: the card's sweeps over all
2^32 inputs are in ``tests/test_torch_cuda.py``.

Tolerances: the table equals the generator to 2^-50 relative (a libm's
``tanh`` may differ by an ulp across machines); the model's kept values
equal ``fmath.tanh`` bit for bit.
"""

import shutil

import numpy as np
import pytest
import torch

from oscen_tpu_torch.ops import fmath
from oscen_tpu_torch.ops.cuda import build, iir
from oscen_tpu_torch.ops.cuda import tanh_table as tt

HEADER = build.CSRC_DIR / "tanh_table.cuh"


@pytest.fixture(scope="module")
def coef():
    return tt.parse(HEADER.read_text())


def test_header_is_the_generators_table(coef):
    gen = tt.coefficients()
    assert coef.shape == gen.shape == (tt.INTERVALS, tt.DEGREE + 1)
    scale = np.maximum(np.abs(gen), 1e-300)
    assert float(np.max(np.abs(coef - gen) / scale)) <= 2.0 ** -50
    text = HEADER.read_text()
    assert f"#define OSCEN_TANH_INTERVALS {tt.INTERVALS}" in text
    assert f"{tt.SATURATION.hex()}f" in text
    assert f"#define OSCEN_TANH_MARGIN {tt.MARGIN}" in text


def test_saturation_is_the_first_float_whose_tanh_rounds_to_one():
    a = np.float32(tt.SATURATION)
    below = np.nextafter(a, np.float32(0))
    one = fmath.tanh(torch.tensor([below, a]))
    assert one[0] < 1.0 and one[1] == 1.0
    # the table's last interval reaches past it
    assert (tt.INTERVALS - 0.5) * tt.STEP > tt.SATURATION


def _inputs(n, seed):
    """Seeded float32 inputs: uniform bit patterns (every binade, NaN and
    inf), every binade of |b| below 16 sampled evenly, and the dense range
    [-10, 10] the twin peaks' filter sees."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2 ** 32, n // 2, dtype=np.uint64).astype(np.uint32)
    exps = rng.integers(0, 131, n // 4).astype(np.uint32)   # up to 2^4
    mant = rng.integers(0, 2 ** 23, n // 4, dtype=np.uint64).astype(np.uint32)
    sign = rng.integers(0, 2, n // 4).astype(np.uint32) << 31
    binades = (sign | (exps << 23) | mant).view(np.float32)
    dense = rng.uniform(-10, 10, n - n // 2 - n // 4).astype(np.float32)
    return np.concatenate([bits.view(np.float32), binades, dense])


def test_model_keeps_only_the_rounded_float64_tanh(coef):
    """10^7 seeded inputs: every value the rounding test keeps equals the
    float64 tanh rounded once bit for bit, the inputs it cannot decide (and
    only those, NaN among them) take the fallback, and they are rare."""
    b = _inputs(10 ** 7, seed=8)
    y, kept = tt.model(b, coef)
    ref = fmath.tanh(torch.from_numpy(b)).numpy()
    same = (y.view(np.uint32) == ref.view(np.uint32)) | (
        np.isnan(y) & np.isnan(ref))
    assert not (kept & ~same).any()
    assert not kept[np.isnan(b)].any()
    finite = ~np.isnan(b)
    undecided = int((~kept & finite).sum())
    assert undecided < 1e-4 * finite.sum()
    # every binade of |b| from denormals to 2^4 is in the sample
    e = (np.abs(b[finite]).view(np.uint32) >> 23)
    assert set(range(131)) <= set(e.tolist())


def test_rounding_test_sends_near_midpoint_values_to_the_fallback(coef):
    """Inputs whose float64 tanh lies near a float32 midpoint: the model's
    fast value is wrong for some of them if kept blindly, and the rounding
    test keeps none of those."""
    rng = np.random.default_rng(3)
    b = rng.uniform(-9.5, 9.5, 2 * 10 ** 6).astype(np.float32)
    t = np.tanh(b.astype(np.float64))
    y = t.astype(np.float32)
    gap = np.abs(np.nextafter(y, np.float32(np.inf)) - y).astype(np.float64)
    near = np.abs(np.abs(t - y) - gap / 2) < gap * 2.0 ** -12
    b = b[near]
    assert len(b) > 100
    got, kept = tt.model(b, coef)
    ref = fmath.tanh(torch.from_numpy(b)).numpy()
    assert not (kept & (got != ref)).any()
    assert (~kept).any()


def test_tanh_exact_on_the_cpu_is_fmath_tanh():
    b = torch.from_numpy(_inputs(4096, seed=2))
    y, undecided = iir.tanh_exact(b)
    ref = fmath.tanh(b)
    assert torch.equal(torch.nan_to_num(y, nan=7.0),
                       torch.nan_to_num(ref, nan=7.0))
    nans = int(torch.isnan(b).sum())
    assert nans <= undecided <= nans + 2


def test_card_checks_need_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        iir.tanh_exact_sweep("cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        iir.div_sweep(torch.ones(4))


def test_build_digest_follows_every_header(tmp_path):
    """An edited ``csrc/*.cuh`` changes every source's build key (so no
    stale library loads); a header elsewhere does not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    before = {n: build.source_digest(n, csrc) for n in ("iir", "phase")}
    assert before == {n: build.source_digest(n) for n in before}
    (tmp_path / "other.cuh").write_text("// not under csrc\n")
    assert build.source_digest("iir", csrc) == before["iir"]
    stage = csrc / "scan_stage.cuh"
    stage.write_text(stage.read_text() + "\n// edited\n")
    after = {n: build.source_digest(n, csrc) for n in before}
    assert all(after[n] != before[n] for n in before)
    (csrc / "iir.cu").write_text((csrc / "iir.cu").read_text() + " ")
    assert build.source_digest("iir", csrc) != after["iir"]


def test_lp18_silence_keeps_a_denormal_state():
    """Why K8's division must be exact for tiny numerators: after noise,
    silence leaves the LP18's state in a denormal limit cycle (the twin
    peaks' cutoff_b 2100 Hz at resonance 0.6), so every step divides a
    denormal numerator, for as long as the input stays silent."""
    g = torch.tensor([np.tan(np.pi * 2100.0 / 48000.0)], dtype=torch.float32)
    h = torch.tensor([1.2], dtype=torch.float32)
    x = torch.tensor(np.random.default_rng(0).standard_normal((1024, 1))
                     * 0.3, dtype=torch.float32)
    _, z = iir.plain_lp18_scan(x, g, h, torch.zeros(3, 1))
    peaks = []
    for _ in range(3):
        _, z = iir.plain_lp18_scan(torch.zeros(8192, 1), g, h, z)
        peaks.append(float(z.abs().max()))
    assert 0.0 < peaks[-1] < 1.2e-38 and peaks[-1] == peaks[-2]
