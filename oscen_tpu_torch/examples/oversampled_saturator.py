"""oversampled_saturator — A/B the anti-aliasing of an oversampled clipper.

Counterpart of ``examples/oversampled_saturator.py``: a saw into a hard
clipper inside a ``* N`` oversampled region, rendered at 1x/2x/4x/8x on
the port; reports the alias energy of each and writes the 1x and 8x
renders to WAV.

Run: python -m oscen_tpu_torch.examples.oversampled_saturator [out_prefix]
     [--seconds 1] [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np

import oscen_tpu_torch
from oscen_tpu_torch.examples import default_path, parser

SR = 44_100.0  # not a multiple of the osc pitch: aliases land off-comb
F0 = 2000.0
FACTORS = (1, 2, 4, 8)
SETTLE = 4096  # samples left out of the alias measure


def build_saturator(factor: int, pkg=oscen_tpu_torch):
    """The reference graph: saw -> hard clip, both inside a rate=factor
    region, sinc-resampled back to base rate; ``pkg`` is any package with
    the same ``Graph`` and nodes."""
    g = pkg.Graph(f"Saturator{factor}x")
    g.output("audio_out", "stream")
    osc = g.add("osc", pkg.PolyBlepOscillator.saw(F0, 0.6), rate=factor)
    clip = g.add("clip", pkg.HardClip(), rate=factor)
    g.connect(osc.output, clip.input)
    g.connect(clip.output, "audio_out", policy="sinc")
    return g


def alias_energy(x: np.ndarray) -> float:
    """Spectral energy away from the true harmonic comb of F0."""
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1 / SR)
    on_comb = np.abs((freqs + F0 / 2) % F0 - F0 / 2) < 80.0
    return float(spec[~on_comb & (freqs > 500)].sum())


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("prefix", nargs="?", default=default_path("saturator"))
    p.add_argument("--seconds", type=float, default=1.0)
    a = p.parse_args(argv)
    n = int(SR * a.seconds)
    renders = {}
    for factor in FACTORS:
        c = build_saturator(factor).compile(SR, block_size=512,
                                            device=a.device)
        renders[factor] = np.asarray(c.render_mono(n))
    skip = min(SETTLE, n // 2)
    base = alias_energy(renders[1][skip:])
    for factor, audio in renders.items():
        e = alias_energy(audio[skip:])
        print(f"{factor}x oversampling: alias energy {e:10.1f}"
              f"  ({e / base:6.1%} of 1x)")
    for factor in (1, 8):
        path = f"{a.prefix}_{factor}x.wav"
        oscen_tpu_torch.AudioAsset.write_wav(path, renders[factor] * 0.8,
                                             int(SR))
        print(f"wrote {path}")
    return np.stack([renders[f] for f in FACTORS])


if __name__ == "__main__":
    main()
