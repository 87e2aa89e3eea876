"""Captured blocks: a block-mode block as one CUDA-graph replay.

The port's counterpart of what ``jax.jit`` gives the JAX package's
``CompiledGraph`` (``oscen_tpu/graph/compile.py``): every block function
is jitted (``:1098-1099``), so a steady block is ONE cached jit call
(``:579-583``, ``:1287-1292``), ``render_steady`` one jitted ``lax.scan``
over the span (``:1398-1426``) and ``steady_checksum`` one jitted
``fori_loop`` (``:1592-1627``).  On a CUDA card the counterpart of a jitted
fixed-shape function that never reads the card is a ``torch.cuda.CUDAGraph``
captured around one call of the block function, then replayed.

A :class:`CapturedBlock` owns static buffers: the state leaves, the
``per_block`` tensors and the ``EventBuffer`` tensors of its block, cloned
when it is built.  Its graph runs the block function on them and writes the
new state back into the static state leaves with ``copy_``, so a replay
advances the state in place; the outputs are the graph's own tensors, which
the next replay overwrites (callers copy them out).  With a checksum it
also adds ``sum(out ** 2)`` of every stream output into a static scalar.
A replay first copies into the static buffers whatever input is not already
that buffer (a state set from outside, a new staging, a block's audio), so
it runs from exactly the inputs an eager call would get.  On the CPU the
same protocol runs, with the block function called on the static buffers
where the card replays the graph: every line but the capture itself, bit
for bit the eager result.

:class:`BlockCaptures` keys the captures of one ``CompiledGraph`` on
everything the block function decides on the host, the counterpart of a
JAX retrace: a key that no longer matches builds a new capture and never
replays a stale one.  The key, from an audit of ``graph/block_mode.py``'s
``make_block_fn`` and every node's block methods:

- the block function itself: the block length B, the literal parameters
  (graph parameters never set since compile, ``literal_ins`` and
  ``folded_ins``) and the voice sharding (``CompiledGraph._block_fn_key``);
- the names, shapes and dtypes of the staged ``per_block`` tensors: a value
  staged ``[1]`` is block-constant (``const_ins``, the const-output
  propagation, the epilogue fusion's dynamic half, the tremolo's own
  path), a step staged ``(3, C)`` expands on the device; and the event
  buffers' shapes (a capacity of 0 means no events) with their host slots
  (``EventBuffer.slots``);
- the names, shapes and dtypes of the state leaves: ``publish_asset`` can
  grow a Convolver's IR, a voice-class switch or a state setter brings
  another state;
- the ``host_ins`` values: the graph parameters that feed a node whose
  block methods name ``host_ins`` (the pivot's and fm chains' zero-feedback
  branch, the filters' hoisted coefficients, the oscillators' constant
  frequency path), read through ``CompiledGraph._host_params``;
- the ``host_mirror`` values: the Convolver's ``fade_pos``
  (``nodes/convolver.py``: a fading block runs the second irFFT and the
  crossfade, a steady one does not), so each fade block has a key of its
  own and stays eager (seen once), and the steady block after the fade is
  captured;
- ``OSCEN_ADDITIVE_KERNEL``, which the additive wrapper reads at every
  call (``OSCEN_EPILOGUE_FUSION`` is read when the block function is
  built, so the block function carries it).

Nothing else is read on the host inside a block: no node reads the card
(the port's sync-free rule), the scan islands' event slots are in the
staging key, and the node caches (``_Program.const``, a resampler's
halfband coefficients, the additive mix's ticket counters) are filled by
the warm-up.

Capture discipline:

- **Warm before capture.**  A key's first block runs eagerly
  (``WARMUP_BLOCKS``): it sets each kernel's shared-memory opt-in, builds
  the node caches and allocates the additive mix's ticket counters.  A
  block whose state comes back with another structure, shape or dtype than
  it went in is never captured (``eager_why["state_changes_shape"]``).
- **Nothing cached is allocated during capture.**  ``guard()`` (the
  graph's cache sizes) is read before and after the capture; a change
  raises.
- **Nothing freed during capture.**  A dropped graph or CUDA event freed
  by the cyclic garbage collector inside a capture invalidates it, so the
  collector runs just before and is off during the capture.
- **One stream, in order.**  The capture runs on a side stream that waits
  for the current one; every replay launches on the current stream, after
  the work queued before it (the mix's ticket counters are zeroed by the
  launch before).
- **No host reads.**  A replay reads nothing from the card; a capture
  refuses any operation that would.
- **No fallback.**  A capture or a replay that fails raises.

Launch counters: the wrappers count a launch where Python calls them, so a
capture notes what its block launched (``ops.cuda.launch_counters()`` and
``ops.conv.launches``), takes it back, and adds it on each replay: a block
counts the same launches replayed or eager.
"""

from __future__ import annotations

import gc
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.events import EventBuffer
from .node import tree_map

__all__ = ["BlockCaptures", "CapturedBlock", "EAGER_REASONS", "block_checksum",
           "launch_counters", "tree_sig"]

# eager blocks of a key before its capture
WARMUP_BLOCKS = 1
# captures kept per graph (least recently used dropped), keys remembered
MAX_CAPTURES = 16
MAX_KEYS = 256

# why a block ran eagerly (``CompiledGraph.eager_why``)
EAGER_REASONS = ("jit_off", "sample_mode", "sharded", "control", "warmup",
                 "state_changes_shape")


def tree_sig(tree) -> tuple:
    """The structure, shapes and dtypes of a nested dict / tuple / list of
    tensors; dict keys in sorted order."""
    if isinstance(tree, dict):
        return ("d",) + tuple((k, tree_sig(tree[k])) for k in sorted(tree))
    if isinstance(tree, (tuple, list)):
        return ("s",) + tuple(tree_sig(x) for x in tree)
    return (tuple(tree.shape), tree.dtype)


def _staged_sig(per_block: Dict[str, Any], ev_bufs: Dict[str, Any]) -> tuple:
    return (tuple((k, tuple(v.shape), v.dtype)
                  for k, v in sorted(per_block.items())),
            tuple((k, tuple(b.offsets.shape),
                   tuple(sorted((b.slots or {}).items())))
                  for k, b in sorted(ev_bufs.items())))


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def launch_counters() -> List[Dict[str, int]]:
    """Every launch counter a block can advance."""
    from ..ops import conv
    from ..ops.cuda import launch_counters as cuda_counters
    return cuda_counters() + [conv.launches]


def block_checksum(outs: Dict[str, torch.Tensor], names) -> torch.Tensor:
    """``steady_checksum``'s per-block term."""
    return sum(torch.sum(outs[nm] ** 2) for nm in names)


class CapturedBlock:
    """One block function on static buffers on ``device``: a CUDA graph on
    the card, a direct call on the CPU.  ``checksum`` (the stream output
    names) adds their energy into the static scalar ``acc``; ``guard()``
    returns the sizes of the caches that must not grow during the
    capture."""

    def __init__(self, fn: Callable, device: torch.device, state,
                 per_block: Dict[str, Any],
                 ev_bufs: Dict[str, EventBuffer], acc=None,
                 checksum: Optional[List[str]] = None,
                 guard: Optional[Callable[[], Any]] = None):
        self.fn = fn
        self.checksum = checksum
        self.state = tree_map(torch.clone, state)
        self.per_block = {k: v.clone() for k, v in per_block.items()}
        self.ev_bufs = {k: EventBuffer(b.offsets.clone(), b.values.clone(),
                                       b.valid.clone(), b.slots)
                        for k, b in ev_bufs.items()}
        self.acc = acc.clone() if acc is not None else None
        self._static = {_storage(x) for x in _leaves(self.state)}
        # the staging dicts whose tensors the static inputs hold
        self._src: Optional[Tuple[Any, Any]] = (per_block, ev_bufs)
        self.graph = None
        self.outs: Dict[str, torch.Tensor] = {}
        # (counter dict, key, launches) a replay adds
        self.launches: List[Tuple[Dict[str, int], str, int]] = []
        if device.type == "cuda":
            self._capture(device, guard)

    def _aliased(self, t: torch.Tensor) -> bool:
        return _storage(t) in self._static

    def _body(self) -> Dict[str, torch.Tensor]:
        """The block on the static buffers, its new state written back."""
        new_state, outs = self.fn(self.state, self.per_block, self.ev_bufs)
        # an output or a new leaf that views a static leaf is copied first,
        # so the write-back cannot change it under the reader; the outputs
        # are made contiguous here, so copying them out is one memcpy
        outs = {k: v.clone() if self._aliased(v) else v.contiguous()
                for k, v in outs.items()}
        pending = tree_map(
            lambda s, x: None if x is s else
            (x.clone() if self._aliased(x) else x), self.state, new_state)
        tree_map(lambda s, x: x is not None and s.copy_(x), self.state,
                 pending)
        if self.acc is not None:
            self.acc.add_(block_checksum(outs, self.checksum))
        return outs

    def _capture(self, dev: torch.device, guard) -> None:
        counters = launch_counters()
        before = [dict(c) for c in counters]
        sizes = guard() if guard is not None else None
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        # the cyclic collector could free a dropped graph (or its events)
        # in the middle of the capture, a CUDA call a capture forbids: it
        # runs before, and not during, the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    self.outs = self._body()
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        cur.wait_stream(side)
        if guard is not None and guard() != sizes:
            raise RuntimeError(
                "a node or kernel cache was allocated during a CUDA-graph "
                "capture (it would live in the graph's pool); the warm-up "
                "block must fill it")
        for c, b in zip(counters, before):
            for k, n in c.items():
                if n != b.get(k, 0):
                    self.launches.append((c, k, n - b.get(k, 0)))
            c.update(b)
        self.graph = graph

    def load(self, state, per_block, ev_bufs, fresh=None, acc=None) -> None:
        """Copy into the static buffers every input that is not one."""
        if state is not self.state:
            tree_map(lambda s, x: x is s or s.copy_(x), self.state, state)
        if self._src is None or self._src[0] is not per_block \
                or self._src[1] is not ev_bufs:
            for k, s in self.per_block.items():
                x = per_block[k]
                if x is not s:
                    s.copy_(x)
            for k, s in self.ev_bufs.items():
                b = ev_bufs[k]
                for st, x in ((s.offsets, b.offsets), (s.values, b.values),
                              (s.valid, b.valid)):
                    if x is not st:
                        st.copy_(x)
            self._src = (per_block, ev_bufs)
        if fresh:
            for k, x in fresh.items():
                self.per_block[k].copy_(x)
            self._src = None   # those keys no longer hold the staging's
        if acc is not None and acc is not self.acc:
            self.acc.copy_(acc)

    def replay(self) -> Dict[str, torch.Tensor]:
        """One block; returns the static outputs (overwritten by the next
        replay)."""
        if self.graph is None:
            return self._body()
        self.graph.replay()
        for c, k, n in self.launches:
            c[k] += n
        return self.outs


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class BlockCaptures:
    """The captured blocks of one ``CompiledGraph``, by key, with the
    counts of replayed and eager blocks (``counts``: ``replayed``,
    ``eager``, ``captures``; ``eager_why``: the eager blocks by reason,
    ``EAGER_REASONS``)."""

    def __init__(self, device: torch.device,
                 guard: Optional[Callable[[], Any]] = None):
        self.device = device
        self.guard = guard
        self.caps: "OrderedDict[tuple, CapturedBlock]" = OrderedDict()
        self.seen: "OrderedDict[tuple, int]" = OrderedDict()
        self.refused: set = set()
        self.counts = {"replayed": 0, "eager": 0, "captures": 0}
        self.eager_why = {k: 0 for k in EAGER_REASONS}
        self._ids: Dict[tuple, int] = {}
        self._state_memo: Tuple[Any, int] = (None, -1)
        self._staged_memo: Tuple[Any, Any, int] = (None, None, -1)

    def clear(self) -> None:
        """Drop every capture and key (the counts stay)."""
        self.caps.clear()
        self.seen.clear()
        self.refused.clear()
        self._ids.clear()
        self._state_memo = (None, -1)
        self._staged_memo = (None, None, -1)

    def eager(self, why: str) -> None:
        self.counts["eager"] += 1
        self.eager_why[why] += 1

    def _id(self, sig: tuple) -> int:
        i = self._ids.get(sig)
        if i is None:
            i = self._ids[sig] = len(self._ids)
        return i

    def _state_id(self, state) -> int:
        if self._state_memo[0] is not state:
            self._state_memo = (state, self._id(tree_sig(state)))
        return self._state_memo[1]

    def _staged_id(self, per_block, ev_bufs) -> int:
        m = self._staged_memo
        if m[0] is not per_block or m[1] is not ev_bufs:
            m = self._staged_memo = (per_block, ev_bufs, self._id(
                _staged_sig(per_block, ev_bufs)))
        return m[2]

    def run(self, fn_key, fn, state, per_block, ev_bufs, fresh=None,
            acc=None, checksum=None):
        """One block: replayed if its key has a capture (or one is built
        now), eager while the key warms up.  ``fresh`` holds ``per_block``
        entries given anew this block (a stream input); with ``acc`` the
        block adds ``checksum``'s term into it.  Returns ``(new state,
        outputs, acc, replayed)``; a replay's state and outputs are the
        capture's static tensors."""
        fresh_sig = tuple((k, tuple(v.shape), v.dtype)
                          for k, v in sorted(fresh.items())) if fresh else ()
        base = (fn_key, self._staged_id(per_block, ev_bufs), fresh_sig,
                self._state_id(state), fn.host_key())
        key = base + (acc is not None,)
        cap = self.caps.get(key)
        if cap is None and (base in self.refused
                            or self.seen.get(base, 0) < WARMUP_BLOCKS):
            self.seen[base] = self.seen.get(base, 0) + 1
            self.seen.move_to_end(base)
            if len(self.seen) > MAX_KEYS:
                self.seen.popitem(last=False)
            pb = {**per_block, **fresh} if fresh else per_block
            new_state, outs = fn(state, pb, ev_bufs)
            if acc is not None:
                acc = acc + block_checksum(outs, checksum)
            new_id = self._id(tree_sig(new_state))
            self._state_memo = (new_state, new_id)
            if base in self.refused or new_id != base[3]:
                self.refused.add(base)
                self.eager("state_changes_shape")
            else:
                self.eager("warmup")
            return new_state, outs, acc, False
        if cap is None:
            pb = {**per_block, **fresh} if fresh else per_block
            cap = CapturedBlock(fn, self.device, state, pb, ev_bufs, acc=acc,
                                checksum=checksum, guard=self.guard)
            if fresh:
                cap._src = None
            self.caps[key] = cap
            if len(self.caps) > MAX_CAPTURES:
                self.caps.popitem(last=False)
            self.counts["captures"] += 1
        else:
            self.caps.move_to_end(key)
            cap.load(state, per_block, ev_bufs, fresh, acc)
        outs = cap.replay()
        self.counts["replayed"] += 1
        self._state_memo = (cap.state, base[3])
        return cap.state, outs, cap.acc, True
