"""render_convolution — offline convolution-reverb render.

Counterpart of ``examples/render_convolution.py``: load an impulse
response (any rate; it conforms to the graph rate), convolve a dry input,
write the wet result, on the port.  With no IR argument a seeded,
exponentially decaying noise IR is used, so no input file is needed.

Run: python -m oscen_tpu_torch.examples.render_convolution [ir.wav]
     [out.wav] [--seconds 2] [--tail 1] [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np

import oscen_tpu_torch
from oscen_tpu_torch.examples import default_path, parser

SR = 48_000.0
CAPACITY = 1 << 16
CLICKS = (0.0, 0.4, 0.8, 1.2)   # seconds: a plucked arpeggio of clicks


def build_reverb(pkg=oscen_tpu_torch):
    """The reverb graph: a stream input through a ``Convolver`` whose IR
    is the external asset ``ir``."""
    g = pkg.Graph("ConvolutionReverb")
    g.input("x", "stream")
    g.output("out", "stream")
    g.external("ir")
    conv = g.add("conv", pkg.Convolver(max_ir_len=CAPACITY))
    g.connect("ir", conv.ir)
    g.connect("x", conv.input)
    g.connect(conv.output, "out")
    return g


def noise_ir() -> np.ndarray:
    """One second of seeded noise decaying with tau = 0.15 s, x 0.05."""
    rng = np.random.default_rng(0)
    n = int(SR)
    return (rng.standard_normal(n).astype(np.float32)
            * np.exp(-np.arange(n, dtype=np.float32) / (SR * 0.15))
            * 0.05)


def dry_input(seconds: float) -> np.ndarray:
    dry = np.zeros(int(SR * seconds), np.float32)
    for i, t in enumerate(CLICKS):
        if int(t * SR) < len(dry):
            dry[int(t * SR)] = 0.8 * (0.8 ** i)
    return dry


def render(c, asset_cls, ir_path=None, seconds: float = 2.0,
           tail: float = 1.0) -> np.ndarray:
    """Publish the IR (or load ``ir_path``), let the publish crossfade
    settle, then render the dry clicks and the tail through the compiled
    reverb ``c``."""
    if ir_path:
        c.load_wav("ir", ir_path)
    else:
        c.publish_asset("ir", asset_cls.from_samples(noise_ir(), int(SR)))
    c.render_mono(2048)  # let the publish crossfade settle
    dry = dry_input(seconds)
    return np.asarray(c.render_mono(len(dry), stream_inputs={"x": dry},
                                    tail=int(SR * tail)))


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("ir_path", nargs="?", default=None)
    p.add_argument("out_path", nargs="?",
                   default=default_path("reverb_out.wav"))
    p.add_argument("--seconds", type=float, default=2.0,
                   help="length of the dry input")
    p.add_argument("--tail", type=float, default=1.0)
    a = p.parse_args(argv)
    c = build_reverb().compile(sample_rate=SR, block_size=512,
                               device=a.device)
    wet = render(c, oscen_tpu_torch.AudioAsset, a.ir_path, a.seconds,
                 a.tail)
    oscen_tpu_torch.AudioAsset.write_wav(a.out_path, wet, int(SR))
    print(f"wrote {a.out_path} ({len(wet) / SR:.1f} s, "
          f"peak {np.abs(wet).max():.3f})")
    return wet


if __name__ == "__main__":
    main()
