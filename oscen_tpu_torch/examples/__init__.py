"""The seven example programs of the JAX package's ``examples/``, on the
port.  Each runs as ``python -m oscen_tpu_torch.examples.<name>`` on the
CUDA card (``--device cpu`` on the CPU), writes a WAV and returns what it
rendered from ``main(argv)``.

The helpers here drive any compiled graph with the ``queue_event`` /
``set_value`` / ``process_block`` surface, so a test can play an example's
schedule through another implementation of the same model.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

MidiAt = Tuple[int, List[int]]   # (absolute frame, raw MIDI bytes)


def default_path(name: str) -> str:
    """``name`` in the temporary directory (``TMPDIR``)."""
    return os.path.join(tempfile.gettempdir(), name)


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def note_schedule(notes: Sequence[Tuple[float, Sequence[int], int]],
                  gate_seconds: float, sr: float) -> List[MidiAt]:
    """Note-ons at each (seconds, notes, velocity) and their note-offs
    ``gate_seconds`` later, sorted by frame."""
    events: List[MidiAt] = []
    for t0, keys, vel in notes:
        for n in keys:
            events.append((int(t0 * sr), [0x90, n, vel]))
            events.append((int((t0 + gate_seconds) * sr), [0x80, n, 0]))
    events.sort(key=lambda e: e[0])
    return events


def play(synth, raw_midi_event: Callable, events: Sequence[MidiAt],
         total: int, block: int, output: str,
         on_block: Optional[Callable[[object, float], None]] = None
         ) -> list:
    """Render ``total`` frames through ``synth`` in blocks of ``block``,
    queueing the absolute-time MIDI ``events`` (on ``midi_in``) into the
    blocks they fall in; ``on_block(synth, t)`` runs before each block.
    Returns the blocks' ``output`` as ``process_block`` gave them."""
    pending = list(events)
    sr = synth.sample_rate
    chunks = []
    pos = 0
    while pos < total:
        n = min(block, total - pos)
        if on_block is not None:
            on_block(synth, pos / sr)
        while pending and pending[0][0] < pos + n:
            off, msg = pending.pop(0)
            synth.queue_event("midi_in", off - pos, raw_midi_event(msg))
        chunks.append(synth.process_block(n)[output])
        pos += n
    return chunks


def to_numpy(chunks) -> np.ndarray:
    """Blocks (torch tensors, read once at the end, or arrays) as one
    array in time."""
    if chunks and hasattr(chunks[0], "detach"):
        import torch
        return torch.cat(list(chunks)).cpu().numpy()
    return np.concatenate([np.asarray(c) for c in chunks], axis=0)


def normalized(audio: np.ndarray, ceiling: float = 0.9
               ) -> Tuple[np.ndarray, float]:
    """(audio scaled down to ``ceiling`` if its peak is above, the peak)."""
    peak = float(np.abs(audio).max()) if audio.size else 0.0
    if peak > ceiling:
        audio = audio * (ceiling / peak)
    return audio, peak
