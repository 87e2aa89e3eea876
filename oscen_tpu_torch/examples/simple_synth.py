"""simple_synth — render the README synth to a WAV.

Counterpart of ``examples/simple_synth.py``: with no audio device the
output goes to a file, and one block's time prints like the reference's
ad-hoc ns-per-process prints (on the card, the time to queue the block's
work: the host's share).

Run: python -m oscen_tpu_torch.examples.simple_synth [out.wav]
     [--seconds 2] [--device cuda|cpu]
"""

from __future__ import annotations

import time

import numpy as np

from oscen_tpu_torch import AudioAsset
from oscen_tpu_torch.examples import default_path, parser
from oscen_tpu_torch.models.simple import build_simple_synth

SR = 48_000.0


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("out_path", nargs="?",
                   default=default_path("simple_synth.wav"))
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args(argv)
    synth = build_simple_synth().compile(sample_rate=SR, block_size=512,
                                         device=a.device)
    audio = np.asarray(synth.render_mono(int(SR * a.seconds)))

    t0 = time.perf_counter()
    synth.process_block()
    print(f"simple_synth/process_block    time:   "
          f"[{(time.perf_counter() - t0) * 1e9:.0f} ns]")

    AudioAsset.write_wav(a.out_path, audio, int(SR))
    print(f"wrote {a.out_path} ({len(audio) / SR:.1f} s)")
    return audio


if __name__ == "__main__":
    main()
