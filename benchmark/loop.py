"""The audio callback loop, as a plugin host or a live performer's host
runs it: the pattern of the port's ``StreamingHost`` (one callback a block;
the block's MIDI queued, ``process_block()`` called, every stream output
copied into pinned host memory with a CUDA event, and that event awaited
``pipeline_depth`` blocks later), copied here so that the yardstick stays
fixed while the program changes.  Closed loop, no pacing: each callback
starts as soon as the previous one has handed its block over, so the card
sets the rate.

Host spans of each callback, on the host clock: ``traffic`` (the block's
MIDI queued), ``submit`` (``process_block``), ``readback`` (the copy and
its event enqueued) and ``wait`` (the event awaited, the block kept).
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


class Loop:
    def __init__(self, compiled, outputs: List[str], event_input: str,
                 traffic, depth: int, midi_message: Callable):
        self.c = compiled
        self.outputs = outputs
        self.event_input = event_input
        self.traffic = traffic
        self.depth = int(depth)
        self.midi = midi_message
        self.cuda = compiled.device.type == "cuda"
        self.block = 0                   # the next block's index
        # a ring of depth + 1 pinned buffers and events per output
        self._host: List[Dict[str, torch.Tensor]] = []
        self._events: List[Optional[torch.cuda.Event]] = []
        self._pending: List[tuple] = []
        self.kept: Dict[int, Dict[str, np.ndarray]] = {}
        self.keep = set()                # blocks whose outputs are kept
        self.span = nullcontext          # a factory of named host spans

    def _buffers(self, ys: Dict[str, torch.Tensor], slot: int):
        while len(self._host) <= slot:
            self._host.append({k: torch.empty(
                y.shape, dtype=y.dtype, pin_memory=self.cuda)
                for k, y in ys.items()})
            self._events.append(torch.cuda.Event() if self.cuda else None)
        return self._host[slot], self._events[slot]

    def submit(self) -> float:
        """One callback's first half: queue block ``self.block``'s MIDI,
        run it, start its readback.  Returns the callback's start time."""
        i = self.block
        t0 = time.perf_counter()
        with self.span("traffic"):
            for off, status, note, vel in self.traffic.block(i):
                self.c.queue_event(self.event_input, off,
                                   self.midi([status, note, vel]))
        with self.span("submit"):
            out = self.c.process_block()
        with self.span("readback"):
            ys = {k: out[k] for k in self.outputs}
            host, ev = self._buffers(ys, i % (self.depth + 1))
            for k, y in ys.items():
                host[k].copy_(y, non_blocking=self.cuda)
            if ev is not None:
                ev.record()
        self._pending.append((i, t0, host, ev))
        self.block += 1
        return t0

    def settle(self, keep_all: bool = False) -> List[tuple]:
        """One callback's second half: await the blocks more than
        ``depth`` behind (all of them with ``keep_all``).  Returns each
        awaited block's ``(index, start, done)``."""
        done = []
        with self.span("wait"):
            while self._pending and (keep_all
                                     or len(self._pending) > self.depth):
                i, t0, host, ev = self._pending.pop(0)
                if ev is not None:
                    ev.synchronize()
                t1 = time.perf_counter()
                if i in self.keep:
                    self.kept[i] = {k: v.numpy().copy()
                                    for k, v in host.items()}
                done.append((i, t0, t1))
        return done

    def run_blocks(self, n: int) -> None:
        """``n`` callbacks, untimed (set-up)."""
        for _ in range(n):
            self.submit()
            self.settle()
        self.settle(keep_all=True)
