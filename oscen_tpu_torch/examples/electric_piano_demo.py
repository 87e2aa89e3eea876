"""electric_piano_demo — play a chord progression on the flagship model.

Counterpart of ``examples/electric_piano_demo.py``: the electric piano
driven by programmatic MIDI, rendered offline to WAV, here on the port.

Run: python -m oscen_tpu_torch.examples.electric_piano_demo [out.wav]
     [num_voices] [--seconds 5] [--device cuda|cpu]
"""

from __future__ import annotations

from oscen_tpu_torch import AudioAsset, raw_midi_event
from oscen_tpu_torch.examples import (default_path, normalized,
                                      note_schedule, parser, play, to_numpy)
from oscen_tpu_torch.models.electric_piano import build_electric_piano

SR, BLOCK = 48_000.0, 480
CHORDS = [
    (0.0, [60, 64, 67], 100),        # C
    (1.0, [57, 60, 64], 100),        # Am
    (2.0, [65, 69, 72], 100),        # F
    (3.0, [55, 59, 62, 67], 100),    # G7-ish
]
RELEASE_AT = 0.9  # seconds after each chord strike


def render(piano, seconds: float = 5.0,
           raw_midi=raw_midi_event) -> list:
    """The demo's chords through a compiled piano (``out`` per block)."""
    return play(piano, raw_midi, note_schedule(CHORDS, RELEASE_AT, SR),
                int(SR * seconds), BLOCK, "out")


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("out_path", nargs="?",
                   default=default_path("epiano_demo.wav"))
    p.add_argument("num_voices", nargs="?", type=int, default=16)
    p.add_argument("--seconds", type=float, default=5.0)
    a = p.parse_args(argv)
    piano = build_electric_piano(a.num_voices).compile(
        sample_rate=SR, block_size=BLOCK, device=a.device)
    audio = to_numpy(render(piano, a.seconds))
    out, peak = normalized(audio)
    AudioAsset.write_wav(a.out_path, out, int(SR))
    print(f"wrote {a.out_path} ({len(audio) / SR:.1f} s stereo, "
          f"{a.num_voices} voices, peak {peak:.2f})")
    return audio


if __name__ == "__main__":
    main()
