"""fm_synth_demo — render a short phrase on the 3-operator FM synth.

Counterpart of ``examples/fm_synth_demo.py``: programmatic MIDI, the
``route`` crossfade and the filter cutoff swept mid-phrase the way the
reference app's UI sliders would, rendered offline to WAV on the port.

Run: python -m oscen_tpu_torch.examples.fm_synth_demo [out.wav]
     [num_voices] [--seconds 4.5] [--device cuda|cpu]
"""

from __future__ import annotations

from oscen_tpu_torch import AudioAsset, raw_midi_event
from oscen_tpu_torch.examples import (default_path, normalized,
                                      note_schedule, parser, play, to_numpy)
from oscen_tpu_torch.models.fm_synth import build_fm_synth

SR, BLOCK = 48_000.0, 480
NOTES = [
    (0.00, 45, 0.9), (0.50, 57, 0.8), (1.00, 60, 0.8), (1.50, 64, 0.9),
    (2.00, 45, 0.9), (2.50, 55, 0.7), (3.00, 59, 0.8), (3.50, 62, 0.9),
]
GATE_SECONDS = 0.45


def sliders(synth, t: float) -> None:
    """UI-style parameter motion: route sweeps 0 -> 1, the cutoff opens."""
    synth.set_value("route", min(t / 4.0, 1.0))
    synth.set_value("filter_cutoff", 800.0 + 2400.0 * min(t / 4.0, 1.0))


def render(synth, seconds: float = 4.5,
           raw_midi=raw_midi_event) -> list:
    """The demo's phrase through a compiled fm synth (``audio_out``)."""
    notes = [(t0, [n], int(v * 127)) for t0, n, v in NOTES]
    return play(synth, raw_midi,
                note_schedule(notes, GATE_SECONDS, SR), int(SR * seconds),
                BLOCK, "audio_out", on_block=sliders)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("out_path", nargs="?", default=default_path("fm_demo.wav"))
    p.add_argument("num_voices", nargs="?", type=int, default=8)
    p.add_argument("--seconds", type=float, default=4.5)
    a = p.parse_args(argv)
    synth = build_fm_synth(a.num_voices).compile(
        sample_rate=SR, block_size=BLOCK, device=a.device)
    audio = to_numpy(render(synth, a.seconds))
    out, peak = normalized(audio)
    AudioAsset.write_wav(a.out_path, out, int(SR))
    print(f"wrote {a.out_path} ({len(audio) / SR:.1f} s, "
          f"{a.num_voices} voices, peak {peak:.2f})")
    return audio


if __name__ == "__main__":
    main()
