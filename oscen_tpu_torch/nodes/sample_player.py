"""Looping sample playback with a runtime-swappable buffer.

Counterpart of ``oscen_tpu/nodes/sample_player.py`` (the reference
SamplePlayer, sample_player/mod.rs): loops an asset buffer; publishing a
new asset swaps it in and hard-resets the playhead.  The buffer lives in
the state at a fixed capacity (shorter assets zero-pad, a ``length`` field
bounds the loop), so a swap never changes shapes.  The playhead's modular
index is device arithmetic: nothing here reads the card.

Channel mapping (reference SamplePlayerConsumer::build): mono broadcasts,
extra source channels drop, missing channels clamp to the last source
channel.  ``process_block`` takes a leading instance axis (``BATCHED``);
``tick`` broadcasts over it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..assets import AudioAsset
from ..core.types import SampleRate, asset, stream
from ..graph.node import Node, to_device

DEFAULT_CAPACITY = 1 << 18  # 262144 frames ≈ 5.5 s at 48 kHz


class SamplePlayer(Node):
    BATCHED = True

    def __init__(self, channels: int = 1, capacity: int = DEFAULT_CAPACITY):
        self.channels = int(channels)
        self.capacity = int(capacity)
        self.INPUTS = (asset("buf"),)
        self.OUTPUTS = (stream("output", channels=channels),)

    def init_state(self, sr: SampleRate):
        return {
            "buf": torch.zeros((self.capacity, self.channels)),
            "length": torch.tensor(0, dtype=torch.int32),
            "playhead": torch.tensor(0, dtype=torch.int32),
        }

    # ------------------------------------------------------------------ #
    def asset_consume(self, state, a: AudioAsset, sr: SampleRate):
        """Build the playable on the host and swap it in (publish→take
        analogue); the playhead hard-resets (reference
        sample_player/mod.rs:100-127)."""
        src_ch = a.channels
        frames = min(a.frames, self.capacity)
        buf = np.zeros((self.capacity, self.channels), np.float32)
        for c in range(self.channels):
            sc = 0 if src_ch == 1 else min(c, src_ch - 1)
            buf[:frames, c] = a.channel(sc)[:frames]
        dev = state["buf"].device
        return {**state, "buf": to_device(buf, dev),
                "length": torch.full((), frames, dtype=torch.int32,
                                     device=dev),
                "playhead": torch.zeros((), dtype=torch.int32, device=dev)}

    # ------------------------------------------------------------------ #
    def _read(self, state, idx):
        """``buf[idx]`` per instance: ``idx`` is ``[...]`` or ``[..., n]``
        over the state's leading axes; silence until a buffer is loaded."""
        buf = state["buf"]                                  # [..., cap, C]
        lead = buf.dim() - 2
        flat = idx.reshape(idx.shape[:lead] + (-1,))
        v = torch.gather(buf, lead, flat[..., None].expand(
            flat.shape + (self.channels,)).to(torch.int64))
        v = v.reshape(idx.shape + (self.channels,))
        loaded = (state["length"] > 0).reshape(
            state["length"].shape + (1,) * (idx.dim() - lead + 1))
        v = torch.where(loaded, v, torch.zeros((), device=v.device))
        return v[..., 0] if self.channels == 1 else v

    def tick(self, state, ins, sr):
        out = self._read(state, state["playhead"])
        length = torch.clamp(state["length"], min=1)
        playhead = torch.remainder(state["playhead"] + 1, length)
        return {**state, "playhead": playhead}, {"output": out}

    def process_block(self, state, ins, events, sr, block_len):
        length = torch.clamp(state["length"], min=1)[:, None]
        t = torch.arange(block_len, dtype=torch.int32,
                         device=state["buf"].device)
        idx = torch.remainder(state["playhead"][:, None] + t, length)
        out = self._read(state, idx)
        playhead = torch.remainder(state["playhead"] + block_len,
                                   length[:, 0])
        return {**state, "playhead": playhead}, {"output": out}
