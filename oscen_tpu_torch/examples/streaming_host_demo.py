"""streaming_host_demo — callback-paced realtime streaming with live events.

Counterpart of ``examples/streaming_host_demo.py``: a wall-clock-paced
block loop at 48 kHz (``utils.host.StreamingHost``) with MIDI note events
and parameter changes arriving live between callbacks, plus deadline
accounting, on the port's 8-voice poly synth.

Run: python -m oscen_tpu_torch.examples.streaming_host_demo [seconds]
     [block] [--out out.wav] [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np

from oscen_tpu_torch import AudioAsset, raw_midi_event
from oscen_tpu_torch.examples import default_path, parser
from oscen_tpu_torch.models.poly_synth import build_poly_synth
from oscen_tpu_torch.utils.host import StreamingHost

NOTES = [57, 60, 64, 67, 64, 60]


def live_controls(raw_midi=raw_midi_event):
    """The callback ``on_block(host, t)``: a new note every 0.4 s, released
    after 0.3 s, and a filter sweep (the UI-slider analogue)."""
    state = {"next_note": 0.0, "i": 0, "held": None}

    def on_block(h, t):
        if state["held"] is not None and t >= state["held"][0]:
            h.compiled.queue_event(
                "midi_in", 0, raw_midi([0x80, state["held"][1], 0]))
            state["held"] = None
        if t >= state["next_note"]:
            note = NOTES[state["i"] % len(NOTES)]
            h.compiled.queue_event("midi_in", 0, raw_midi([0x90, note, 100]))
            state["held"] = (t + 0.3, note)
            state["next_note"] = t + 0.4
            state["i"] += 1
        if "cutoff" in h.compiled._params:
            h.compiled.set_value("cutoff",
                                 800.0 + 2200.0 * (0.5 + 0.5 * np.sin(t)))
    return on_block


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("seconds", nargs="?", type=float, default=3.0)
    p.add_argument("block", nargs="?", type=int, default=128)
    p.add_argument("--out", default=default_path("streaming_demo.wav"))
    a = p.parse_args(argv)
    synth = build_poly_synth(8).compile(48000.0, block_size=a.block,
                                        mode="block", device=a.device)
    host = StreamingHost(synth)
    # Warm up every path outside the paced loop (steady blocks and
    # event-carrying blocks; on the card the kernels' first launches),
    # then reset the state.
    synth.queue_event("midi_in", 0, raw_midi_event([0x90, 60, 100]))
    synth.process_block()
    synth.queue_event("midi_in", 0, raw_midi_event([0x80, 60, 0]))
    synth.queue_event("midi_in", 4, raw_midi_event([0x90, 62, 100]))
    synth.process_block()
    synth.process_block()
    synth.init()
    audio = host.run(a.seconds, on_block=live_controls())
    host.print_report()
    AudioAsset.write_wav(a.out, audio, 48000)
    print(f"wrote {a.out} ({len(audio) / 48000.0:.1f} s)")
    return audio


if __name__ == "__main__":
    main()
