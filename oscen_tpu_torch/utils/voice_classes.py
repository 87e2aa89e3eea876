"""Conservative voice-capacity classes: host-side kernel gating.

Counterpart of ``oscen_tpu/utils/voice_classes.py``.  The reference skips
inactive voices per sample via ``is_active`` (graph/traits.rs:44-52).  On
the card the voices are a batch axis computed branchlessly, and learning
that a release tail finished would need a read of the card per block.
Instead, the host already knows everything it needs *conservatively*:
which voices hold notes (the allocator's tables) and a worst-case
release-tail timer after each note-off.

:class:`VoiceClassHost` compiles one variant of a polyphonic graph per
capacity class (e.g. 64, 128 and 256 voices) and, between blocks, switches
to the smallest class that fits every *maybe-live* voice:

- **down-switch**: busy voices are compacted to the front (a host-chosen
  permutation applied to per-voice device state, host handler instances
  and the allocator tables), idle tails beyond the class boundary are
  dropped: by construction they are ``tail_seconds`` past release, i.e.
  below the audibility threshold the caller chose;
- **up-switch**: happens *before* a block whose pending note-ons could
  overflow the current class (so allocator stealing behaves exactly as
  the full-capacity graph), new slots start from pristine init state.

No switch reads the card: the permutation goes to the device once per
switch from pinned memory, without waiting, and the per-voice leaves are
gathered there (``index_select``).

The allocator's release clock advances only in ``host_process``, which a
steady block skips (it reuses its staging), so a release tail counts the
blocks that ran the host prepass; without events the host never
down-switches.  That is conservative (no voice is dropped early) and is
the JAX package's behaviour too, so both switch at the same blocks.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.events import NoteOnEvent
from ..graph.node import to_device, tree_map
from ..nodes.voice_allocator import VoiceAllocator, _VoiceState

__all__ = ["VoiceClassHost"]


class VoiceClassHost:
    def __init__(self, build_graph: Callable[[int], "object"],
                 capacities=(128, 256), sample_rate: float = 48000.0,
                 block_size: int = 512, mode: str = "block",
                 tail_seconds: float = 1.0, device="cuda"):
        self.capacities = sorted(int(c) for c in capacities)
        self.variants = {
            c: build_graph(c).compile(sample_rate, block_size=block_size,
                                      mode=mode, device=device)
            for c in self.capacities}
        self.active_cap = self.capacities[-1]
        self.tail_frames = int(tail_seconds * sample_rate)
        self.switches = 0
        # voice-array node names (count equals the variant capacity) and
        # the allocator node, resolved per variant
        self._voice_nodes: Dict[int, List[str]] = {}
        self._alloc_name: Optional[str] = None
        for c, comp in self.variants.items():
            names = [n for n, inst in comp.ir.nodes.items()
                     if inst.count == c]
            self._voice_nodes[c] = names
            mirrored = [n for n in names if n in comp._mirrors]
            if mirrored:
                raise ValueError(
                    f"voice-array nodes {mirrored} keep a host mirror of "
                    f"their state; a class switch cannot permute it")
            for n, inst in comp.ir.nodes.items():
                if isinstance(inst.node, VoiceAllocator):
                    self._alloc_name = n
        if self._alloc_name is None:
            raise ValueError("graph has no VoiceAllocator — voice classes "
                             "need host-visible note tracking")
        # pristine per-voice init state for up-switch padding
        self._init_state = {
            c: comp.prog.init_device_state()
            for c, comp in self.variants.items()}

    # ------------------------------------------------------------------ #
    @property
    def compiled(self):
        return self.variants[self.active_cap]

    def queue_event(self, name, frame_offset, payload):
        self.compiled.queue_event(name, frame_offset, payload)

    def set_value(self, name, v):
        for comp in self.variants.values():
            comp.set_value(name, v)

    # ------------------------------------------------------------------ #
    def _alloc(self, cap: int) -> VoiceAllocator:
        comp = self.variants[cap]
        insts = comp.prog.host_instances.get(self._alloc_name)
        return insts[0] if insts else comp.ir.nodes[self._alloc_name].node

    def _pending_note_ons(self) -> int:
        n = 0
        for q in self.compiled._event_queues.values():
            for ev in q:
                data = getattr(ev.payload, "bytes", None)  # raw MIDI
                if data is not None and len(data) >= 3 \
                        and (data[0] & 0xF0) == 0x90 and data[2] > 0:
                    n += 1
                elif isinstance(ev.payload, NoteOnEvent):
                    n += 1
        return n

    def _switch(self, target: int) -> None:
        src = self.compiled
        dst = self.variants[target]
        cur_cap = self.active_cap
        alloc = self._alloc(cur_cap)
        busy = alloc.busy_mask(self.tail_frames)
        order = [i for i, b in enumerate(busy) if b] + \
                [i for i, b in enumerate(busy) if not b]
        if target >= cur_cap:
            order = list(range(cur_cap))  # up-switch: keep layout
        alloc.permute(order)

        # device state: voice-array nodes gather their leading axis; the
        # added slots come from the target's pristine init state;
        # everything else copies through
        take = min(cur_cap, target)
        # the slot order goes to the device from pinned memory without
        # waiting (a pageable index would make the gather wait)
        perm = to_device(np.asarray(order[:take], np.int64), dst.device)
        init = self._init_state[target]

        def move(leaf, ini):
            leaf = leaf.index_select(0, perm)
            if target > take:
                leaf = torch.cat([leaf, ini[take:]], dim=0)
            return leaf

        voice_nodes = self._voice_nodes[cur_cap]
        new_state = dict(init)
        for name, sub in src.state.items():
            if name in ("__fb__", "__rs__"):
                continue  # rebuilt below: per-voice entries by node name
            if name in voice_nodes:
                new_state[name] = tree_map(move, sub, init[name])
            else:
                new_state[name] = sub
        # feedback carries / resampler histories: per-voice entries keyed
        # by node name
        for special in ("__fb__", "__rs__"):
            if special not in src.state:
                continue
            ns = {}
            for k, v in src.state[special].items():
                node = k.rsplit(".", 1)[0] if special == "__fb__" else None
                if node in voice_nodes:
                    v = move(v, init[special][k])
                ns[k] = v
            new_state[special] = ns
        dst.state = new_state
        # the host mirrors of the non-voice nodes (no voice-array node
        # has one: the constructor refuses such graphs)
        for name, m in src._mirrors.items():
            dst._mirrors[name] = dict(m)

        # host handler instances (per-voice control state)
        for name in voice_nodes:
            insts = src.prog.host_instances.get(name)
            if not insts:
                continue
            dst_insts = dst.prog.host_instances[name]
            for j in range(take):
                dst_insts[j].restore_host_state(
                    insts[order[j]].host_state())
            for j in range(take, target):
                dst_insts[j].reset()

        # allocator tables: truncate/extend the permuted table
        dst_alloc = self._alloc(target)
        snap = alloc.host_state()
        st = snap["_state"][:take]
        while len(st) < target:
            st.append(_VoiceState())
        dst_alloc._state = st
        dst_alloc._age = snap["_age"]
        dst_alloc._frames = snap["_frames"]

        # params / ramps stay continuous across the switch
        for pname, r in src._params.items():
            d = dst._params[pname]
            d.current, d.target = r.current, r.target
            d.increment = r.increment
            d.frames_remaining = r.frames_remaining
        # pending events move over
        for qname, q in src._event_queues.items():
            dst._event_queues[qname].extend(q)
            q.clear()
        # the destination's host caches describe the last time it was
        # active: its per-instance steady outputs and its staged block
        # would replay stale control data (the JAX package keeps them, and
        # a class left and re-entered plays the old notes' controls)
        dst._host_steady.clear()
        dst._staging_cache.clear()
        dst._control_dirty = True
        src._control_dirty = True
        self.active_cap = target
        self.switches += 1

    # ------------------------------------------------------------------ #
    def process_block(self, *a, **kw):
        # up-switch BEFORE the block if pending note-ons could overflow
        # (so stealing semantics match the full-capacity graph)
        alloc = self._alloc(self.active_cap)
        busy_n = sum(alloc.busy_mask(self.tail_frames))
        need = busy_n + self._pending_note_ons()
        if need > self.active_cap:
            for c in self.capacities:
                if c >= min(need, self.capacities[-1]):
                    if c > self.active_cap:
                        self._switch(c)
                    break
        out = self.compiled.process_block(*a, **kw)
        # down-switch after: smallest class holding every busy voice
        alloc = self._alloc(self.active_cap)
        busy_n = sum(alloc.busy_mask(self.tail_frames))
        for c in self.capacities:
            if c >= busy_n and c < self.active_cap:
                self._switch(c)
                break
        return out
