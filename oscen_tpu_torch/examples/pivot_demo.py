"""pivot_demo — the reference's flagship Pivot synth, rendered offline.

Counterpart of ``examples/pivot_demo.py``: an 8-voice, 3-operator FM
synth whose ``route`` parameter pivots OP3's modulation between OP2
(route=0) and the carrier (route=1), with operator-3 feedback 0.3 and a
filter envelope, driven by programmatic MIDI, on the port.

Run: python -m oscen_tpu_torch.examples.pivot_demo [out.wav] [num_voices]
     [--seconds 5.2] [--device cuda|cpu]
"""

from __future__ import annotations

from oscen_tpu_torch import AudioAsset, raw_midi_event
from oscen_tpu_torch.examples import (default_path, normalized,
                                      note_schedule, parser, play, to_numpy)
from oscen_tpu_torch.models.pivot import build_pivot

SR, BLOCK = 48_000.0, 480
CHORDS = [
    (0.0, (48, 60, 64, 67), 100),   # Cmaj
    (1.2, (45, 57, 60, 64), 100),   # Am
    (2.4, (41, 53, 57, 60), 100),   # F
    (3.6, (43, 55, 59, 62), 100),   # G
]
GATE_SECONDS = 1.0


def setup(synth) -> None:
    """The demo's fixed slider positions."""
    synth.set_value("op3_feedback", 0.3)
    synth.set_value("filter_env_amount", 1500.0)


def pivot_route(synth, t: float) -> None:
    synth.set_value("route", min(t / 4.0, 1.0))  # pivot OP3 -> carrier


def render(synth, seconds: float = 5.2,
           raw_midi=raw_midi_event) -> list:
    """The demo's chords through a compiled pivot (``audio_out``)."""
    setup(synth)
    return play(synth, raw_midi,
                note_schedule(CHORDS, GATE_SECONDS, SR), int(SR * seconds),
                BLOCK, "audio_out", on_block=pivot_route)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("out_path", nargs="?",
                   default=default_path("pivot_demo.wav"))
    p.add_argument("num_voices", nargs="?", type=int, default=8)
    p.add_argument("--seconds", type=float, default=5.2)
    a = p.parse_args(argv)
    synth = build_pivot(a.num_voices).compile(
        sample_rate=SR, block_size=BLOCK, device=a.device)
    audio = to_numpy(render(synth, a.seconds))
    out, peak = normalized(audio)
    AudioAsset.write_wav(a.out_path, out, int(SR))
    print(f"wrote {a.out_path} ({len(audio) / SR:.1f} s, "
          f"{a.num_voices} voices, peak {peak:.2f})")
    return audio


if __name__ == "__main__":
    main()
