"""Captured blocks: a block as one CUDA-graph replay.

The port's counterpart of what ``jax.jit`` gives the JAX package's
``CompiledGraph`` (``oscen_tpu/graph/compile.py``): every block function
is jitted (``:1098-1099``), so a steady block is ONE cached jit call
(``:579-583``, ``:1287-1292``), an event block one call of its packed
variant (``:1235-1297``, ``_packed_call`` ``:1309-1367``), a parameter
change or a ramp a call of the steady variant, a sample-mode block one
jitted ``lax.scan`` of the per-sample step (``:1047-1071``), a
voice-sharded block one jitted ``shard_map`` (``:1086-1099``),
``render_steady`` one jitted ``lax.scan`` over the span (``:1398-1426``)
and ``steady_checksum`` one jitted ``fori_loop`` (``:1592-1627``).  On a
CUDA card the counterpart of a jitted fixed-shape function that never
reads the card is a ``torch.cuda.CUDAGraph`` captured around one call of
the block function, then replayed: a block-mode block function, or the
sample-mode one, whose B steps the capture records one after another
(``CompiledGraph._make_scan_fn``; ~10^5 kernel nodes a B=1024 block).  A
voice-sharded block's all-reduces are NCCL collectives on the capturing
stream, captured with the rest; gloo's wait for the card on the host,
which a capture refuses, so a sharded block on a card whose group is not
NCCL runs eagerly (:func:`eager_reason`).

A block's inputs arrive as a :class:`Staging`: every host array of the
block (parameters, host values, event buffers, stream audio) packed into
one float32 vector in pinned memory, its layout, the event buffers' host
slots, and the stream inputs that are tensors on the device already.  A
:class:`CapturedBlock` owns static buffers: the state leaves, ONE packed
vector of its layout, and the on-device inputs, cloned when it is built.
Its graph unpacks the vector (the per-block views, the event offsets as
int32, the valid masks; :func:`unpack`, the JAX package's ``packed_fn``),
runs the block function and writes the new state back into the static
state leaves with ``copy_``, so a replay advances the state in place; the
outputs are the graph's own tensors, which the next replay overwrites
(callers copy them out).  With a checksum it also adds ``sum(out ** 2)``
of every stream output into a static scalar.  A replay first copies into
the static buffers whatever input is not already there: a state set from
outside, a new staging (one non-blocking copy of the pinned vector
straight into the static one), a block's audio.  So a control block is
the host prepass, one fill of a pinned buffer, one copy and one graph
launch, and it runs from exactly the inputs an eager call would get.  On
the CPU the same protocol runs, with the block function called on the
static buffers where the card replays the graph: every line but the
capture itself, bit for bit the eager result.

:class:`BlockCaptures` keys the captures of one ``CompiledGraph`` on
everything the block function decides on the host, the counterpart of a
JAX retrace: a key that no longer matches builds a new capture and never
replays a stale one.  The key, from an audit of ``graph/block_mode.py``'s
``make_block_fn``, every node's block methods and the control path
(``CompiledGraph._host_prepass`` and ``_stage``):

- the block function itself: the block length B, the literal parameters
  (graph parameters never set since compile, ``literal_ins`` and
  ``folded_ins``: the first ``set_value`` of a parameter turns it dynamic
  and builds another block function; block mode only, as sample mode's
  ticks read none) and the voice sharding (``CompiledGraph._block_fn_key``);
- the staging's layout: the names, kinds and shapes of the packed arrays,
  in order.  A value staged ``[1]`` is block-constant (``const_ins``, the
  const-output propagation, the epilogue fusion's dynamic half, the
  tremolo's own path), a ramp ``[B]``; a host value of a node array
  ``[1, C]`` is block-constant, its ``__hstep__`` step ``(3, C)`` expands
  on the device (``CompiledGraph._host_prepass``), and so the fm and pivot
  chains' ``dt`` is per-sample on a note-on block (a ``const_ins``
  decision, ``models/fm_synth.py``); an event buffer's shape carries its
  power-of-two capacity (``_round_capacity``: a capacity of 0 means no
  events, and a note-on block of capacity 1, 2 or 4 is a key each).  The
  event offsets, values and masks are data: block-mode nodes read them on
  the device.  The host slots (``EventBuffer.slots``) are in the key only
  where the block function reads them (``block_fn.reads_slots``: a scan
  island, a node whose block is its tick scan, and every sample-mode
  block apply events at the slots, ``Node.apply_events_scheduled``; so a
  scan island's block whose events fall at other offsets than any before
  is its key's warm-up, where the JAX package traces once for every
  layout); elsewhere a capture's block gets no slots, so no slot the
  capture saw can reach a replay.  A sample-mode block that carries
  events is not captured at all (``eager_why["sample_events"]``): its
  capture records all B steps, about two eager blocks' time, and pays
  back only where the same offsets recur at least three more times, a
  property of the traffic that no reading has shown.  The shapes and
  dtypes of the stream inputs that are tensors on the device, and of
  ``fresh`` ones, are in it too;
- the names, shapes and dtypes of the state leaves: ``publish_asset`` can
  grow a Convolver's IR, a voice-class switch or a state setter brings
  another state;
- the ``host_ins`` values (block mode; sample mode's ticks are given only
  their ``folded_ins``, fixed when the step is built, so its block
  function reads nothing else on the host): the graph parameters that
  feed a node whose block methods name ``host_ins`` (the pivot's and fm chains' zero-feedback
  branch, the filters' hoisted coefficients, the oscillators' constant
  frequency path), read through ``CompiledGraph._host_params`` where the
  staging holds the parameter as ``[1]`` (a block reads no other: a
  ramping parameter's value is not in the key, so a ramp's blocks share
  one);
- the ``host_mirror`` values: the Convolver's ``fade_pos``
  (``nodes/convolver.py``: a fading block runs the second irFFT and the
  crossfade, a steady one does not), so each fade block has a key of its
  own and stays eager (seen once), and the steady block after the fade is
  captured;
- ``OSCEN_ADDITIVE_KERNEL``, which the additive wrapper reads at every
  call (``OSCEN_EPILOGUE_FUSION`` is read when the block function is
  built, so the block function carries it).

Nothing else is read on the host inside a block: no node reads the card
(the port's sync-free rule), and the node caches (``_Program.const``, a
resampler's halfband coefficients, the additive mix's ticket counters)
are filled by the warm-up.

Capture discipline:

- **Warm before capture.**  A key's first block runs eagerly
  (``WARMUP_BLOCKS``): it sets each kernel's shared-memory opt-in, builds
  the node caches, allocates the additive mix's ticket counters and, on a
  sharded graph, runs the group's first collective (NCCL builds its
  communicator there, never inside a capture).  So a
  one-off control block (a ``set_value``, one step of a ``host_ins``
  sweep, a fade block) is its key's warm-up and runs eagerly; a repeated
  one (events every block in block mode, a ramp's blocks) replays.  A block whose state
  comes back with another structure, shape or dtype than it went in is
  never captured (``eager_why["state_changes_shape"]``).
- **Nothing cached is allocated during capture.**  ``guard()`` (the
  graph's cache sizes) is read before and after the capture; a change
  raises.
- **Nothing freed during capture.**  A dropped graph or CUDA event freed
  by the cyclic garbage collector inside a capture invalidates it, so the
  collector runs just before and is off during the capture.
- **One stream, in order.**  The capture runs on a side stream that waits
  for the current one; every replay launches on the current stream, after
  the work queued before it (the mix's ticket counters are zeroed by the
  launch before; the copy into the static vector waits for the replay
  before that has read it).
- **One memory pool a graph.**  The captures of one ``BlockCaptures``
  allocate from one pool (``torch.cuda.graph_pool_handle``) on one side
  stream (the caching allocator reuses a free block only on the stream
  it was allocated on), so a capture reuses what an earlier one freed
  instead of holding a pool of its own.  Only the outputs of a capture
  outlive it in that pool, and a later replay may overwrite them; that is
  safe because replays run one at a time on one stream, every caller
  copies a replay's outputs out before the next (``CompiledGraph._own``,
  ``render_steady``), and the static buffers (state, packed vector,
  inputs, checksum) are allocated outside any capture.
- **The pinned vector outlives its copy.**  Each staging packs into a
  pinned buffer of its own from PyTorch's caching host allocator, which
  records the copy on the stream and hands the buffer out again only
  after it; nothing synchronizes.
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
import math
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.events import EventBuffer
from .node import tree_map

__all__ = ["BlockCaptures", "CapturedBlock", "EAGER_REASONS", "Staging",
           "block_checksum", "eager_reason", "launch_counters", "tree_sig",
           "unpack"]

# eager blocks of a key before its capture
WARMUP_BLOCKS = 1
# captures kept per graph (least recently used dropped), keys remembered
MAX_CAPTURES = 16
MAX_KEYS = 256

# why a block ran eagerly (``CompiledGraph.eager_why``): ``jit=False``; a
# sample-mode block that carries events; a voice-sharded block on a card
# whose group is not NCCL (:func:`eager_reason`); a key's warm-up; a block
# whose state changes structure
EAGER_REASONS = ("jit_off", "sample_events", "sharded", "warmup",
                 "state_changes_shape")


def eager_reason(jit: bool, device: torch.device, backend: Optional[str],
                 sample_events: bool = False) -> Optional[str]:
    """Why a block on ``device`` runs eagerly whatever its key, or None
    when :class:`BlockCaptures` takes it: ``"jit_off"`` without ``jit``;
    ``"sample_events"`` for a sample-mode block that carries events
    (``sample_events``): its key would hold the events' offsets, and a
    capture of its B steps costs about two eager blocks, which only a
    layout that recurs pays back; ``"sharded"`` for a voice-sharded block
    (``backend``: its group's backend, ``torch.distributed.get_backend``;
    None unsharded) on a card whose group does not run NCCL for CUDA
    tensors: gloo all-reduces a card's tensors through the host, waiting
    for the card, which a capture refuses.  On the CPU every group is
    taken: its stand-in calls the block function on static buffers, and no
    CUDA graph is involved."""
    if not jit:
        return "jit_off"
    if sample_events:
        return "sample_events"
    if backend is not None and device.type == "cuda" \
            and "nccl" not in str(backend):
        return "sharded"
    return None


def tree_sig(tree) -> tuple:
    """The structure, shapes and dtypes of a nested dict / tuple / list of
    tensors; dict keys in sorted order."""
    if isinstance(tree, dict):
        return ("d",) + tuple((k, tree_sig(tree[k])) for k in sorted(tree))
    if isinstance(tree, (tuple, list)):
        return ("s",) + tuple(tree_sig(x) for x in tree)
    return (tuple(tree.shape), tree.dtype)


def _tensors_sig(tensors: Optional[Dict[str, torch.Tensor]]) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype)
                 for k, v in sorted((tensors or {}).items()))


def unpack(packed: torch.Tensor, layout: tuple, slots=None, extra=None
           ) -> Tuple[Dict[str, Any], Dict[str, EventBuffer]]:
    """``(per_block, ev_bufs)`` from a packed float32 vector: ``layout``
    lists ``(kind, key, shape)`` in packing order, kind ``"pb"`` a
    ``per_block`` array (a view), ``"off"`` / ``"val"`` / ``"ok"`` an event
    buffer's offsets (exact in float32 below 2**24, cast to int32), values
    and valid mask (0 / 1, compared with 0.5).  ``slots``: the buffers'
    host slots by key (None: none); ``extra``: ``per_block`` tensors that
    were not packed, added last."""
    per_block: Dict[str, Any] = {}
    parts: Dict[str, Dict[str, torch.Tensor]] = {}
    pos = 0
    for kind, key, shape in layout:
        n = math.prod(shape)
        v = packed[pos:pos + n].view(shape)
        pos += n
        if kind == "pb":
            per_block[key] = v
        else:
            parts.setdefault(key, {})[kind] = (
                v.to(torch.int32) if kind == "off" else
                v > 0.5 if kind == "ok" else v)
    if extra:
        per_block.update(extra)
    ev_bufs = {k: EventBuffer(p["off"], p["val"], p["ok"],
                              None if slots is None else slots.get(k))
               for k, p in parts.items()}
    return per_block, ev_bufs


class Staging:
    """One block's staged inputs (``CompiledGraph._stage``): the host
    arrays packed into one float32 vector ``host`` (pinned when the graph
    lives on a card), its ``layout`` (:func:`unpack`), the event buffers'
    host ``slots`` and ``extra``, the stream inputs that are tensors on the
    device already (not packed, no copy).  The vector goes to the device
    once: into a captured block's static vector (:meth:`copy_to`), or into
    a tensor of its own for an eager block (:meth:`unpack`)."""

    def __init__(self, arrays: Dict[Tuple[str, str], Any],
                 device: torch.device):
        flat = [np.asarray(a, np.float32).ravel() for a in arrays.values()]
        n = sum(f.size for f in flat)
        if device.type == "cuda":
            host = torch.empty((n,), dtype=torch.float32, pin_memory=True)
        else:
            host = torch.empty((n,), dtype=torch.float32)
        if n:
            np.concatenate(flat, out=host.numpy())
        self.host = host
        self.device = device
        self.layout = tuple((kind, key, tuple(np.shape(a)))
                            for (kind, key), a in arrays.items())
        self.slots: Optional[Dict[str, Any]] = None
        self.extra: Dict[str, torch.Tensor] = {}
        self.packed: Optional[torch.Tensor] = None
        self._unpacked = None

    def has_events(self) -> bool:
        """Whether an event is staged at any offset."""
        return any(bool(v) for v in (self.slots or {}).values())

    def shapes(self) -> Dict[str, tuple]:
        """The packed ``per_block`` arrays' shapes by key."""
        return {key: shape for kind, key, shape in self.layout
                if kind == "pb"}

    def sig(self, slots: bool) -> tuple:
        """The staging's part of a capture key; the host slots with
        ``slots``."""
        return (self.layout, _tensors_sig(self.extra),
                tuple(sorted((k, tuple(sorted(v.items())))
                             for k, v in (self.slots or {}).items()))
                if slots else None)

    def to_device(self) -> torch.Tensor:
        """The packed vector on the device, copied once (non-blocking, from
        pinned memory); on the CPU the host vector itself."""
        if self.packed is None:
            self.packed = (self.host.to(self.device, non_blocking=True)
                           if self.device.type == "cuda" else self.host)
        return self.packed

    def copy_to(self, dst: torch.Tensor) -> None:
        """The packed vector into ``dst`` (a captured block's static
        vector): from its device copy if it has one, else straight from
        the pinned buffer, one non-blocking copy."""
        src = self.packed if self.packed is not None else self.host
        dst.copy_(src, non_blocking=True)

    def unpack(self) -> Tuple[Dict[str, Any], Dict[str, EventBuffer]]:
        """``(per_block, ev_bufs)`` on the device, with the host slots (an
        eager block); built once."""
        if self._unpacked is None:
            self._unpacked = unpack(self.to_device(), self.layout,
                                    self.slots or {}, self.extra)
        return self._unpacked


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
    the card, a direct call on the CPU.  The static inputs are the state,
    one packed vector of ``staging``'s layout, and the unpacked inputs
    (``staging.extra`` and ``fresh``); ``slots`` keeps the staging's host
    slots for the block (a block function that reads them), else it gets
    none.  ``checksum`` (the stream output names) adds their energy into
    the static scalar ``acc``; ``guard()`` returns the sizes of the caches
    that must not grow during the capture; on the card ``pool`` is the
    memory pool and the side stream the capture allocates from and runs
    on (``BlockCaptures``: one for all of a graph's captures)."""

    def __init__(self, fn: Callable, device: torch.device, state,
                 staging: Staging, fresh=None, acc=None,
                 checksum: Optional[List[str]] = None,
                 guard: Optional[Callable[[], Any]] = None,
                 slots: bool = False, pool=None):
        self.fn = fn
        self.checksum = checksum
        self.state = tree_map(torch.clone, state)
        self.packed = torch.empty(staging.host.shape, dtype=torch.float32,
                                  device=device)
        staging.copy_to(self.packed)
        self.layout = staging.layout
        self.slots = (staging.slots or {}) if slots else None
        self.extra = {k: v.clone()
                      for k, v in {**staging.extra, **(fresh or {})}.items()}
        self.acc = acc.clone() if acc is not None else None
        self._static = {_storage(x) for x in _leaves(self.state)}
        # the staging whose vector the static one holds
        self._src: Optional[Staging] = staging
        self.graph = None
        self.outs: Dict[str, torch.Tensor] = {}
        # (counter dict, key, launches) a replay adds
        self.launches: List[Tuple[Dict[str, int], str, int]] = []
        if device.type == "cuda":
            self._capture(device, guard, pool)

    def _aliased(self, t: torch.Tensor) -> bool:
        return _storage(t) in self._static

    def _body(self) -> Dict[str, torch.Tensor]:
        """The block on the static buffers, its new state written back."""
        per_block, ev_bufs = unpack(self.packed, self.layout, self.slots,
                                    self.extra)
        new_state, outs = self.fn(self.state, per_block, ev_bufs)
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

    def _capture(self, dev: torch.device, guard, pool) -> None:
        counters = launch_counters()
        before = [dict(c) for c in counters]
        sizes = guard() if guard is not None else None
        graph = torch.cuda.CUDAGraph()
        handle, side = pool
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
                graph.capture_begin(pool=handle)
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

    def load(self, state, staging: Staging, fresh=None, acc=None) -> None:
        """Copy into the static buffers every input that is not one: the
        staging's vector once (it never changes), its on-device inputs and
        ``fresh`` every block."""
        if state is not self.state:
            # a leaf that is another of the static leaves (a publish keeps
            # the current IR as the old one) is read before any is written
            state = tree_map(lambda s, x: x.clone()
                             if x is not s and self._aliased(x) else x,
                             self.state, state)
            tree_map(lambda s, x: x is s or s.copy_(x), self.state, state)
        if self._src is not staging:
            staging.copy_to(self.packed)
            self._src = staging
        for k, x in (*staging.extra.items(), *(fresh or {}).items()):
            s = self.extra[k]
            if x is not s:
                s.copy_(x)
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
    ``EAGER_REASONS``).  Its captures share one memory pool and one
    side stream (``pool``)."""

    def __init__(self, device: torch.device,
                 guard: Optional[Callable[[], Any]] = None):
        self.device = device
        self.guard = guard
        self.caps: "OrderedDict[tuple, CapturedBlock]" = OrderedDict()
        self.seen: "OrderedDict[tuple, int]" = OrderedDict()
        self.refused: set = set()
        self.pool = None
        self.counts = {"replayed": 0, "eager": 0, "captures": 0}
        self.eager_why = {k: 0 for k in EAGER_REASONS}
        self._ids: Dict[tuple, int] = {}
        self._state_memo: Tuple[Any, int] = (None, -1)
        self._staged_memo: Tuple[Any, bool, int] = (None, False, -1)

    def clear(self) -> None:
        """Drop every capture and key (the counts stay), and the pool: the
        allocator releases a pool when its last graph goes, and a capture
        into a released pool's handle fails."""
        self.caps.clear()
        self.pool = None
        self.seen.clear()
        self.refused.clear()
        self._ids.clear()
        self._state_memo = (None, -1)
        self._staged_memo = (None, False, -1)

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

    def _staged_id(self, staging: Staging, slots: bool) -> int:
        m = self._staged_memo
        if m[0] is not staging or m[1] != slots:
            m = self._staged_memo = (staging, slots,
                                     self._id(staging.sig(slots)))
        return m[2]

    def run(self, fn_key, fn, state, staging: Staging, fresh=None,
            acc=None, checksum=None):
        """One block: replayed if its key has a capture (or one is built
        now), eager while the key warms up.  ``fresh`` holds ``per_block``
        entries given anew this block (a stream input); with ``acc`` the
        block adds ``checksum``'s term into it.  Returns ``(new state,
        outputs, acc, replayed)``; a replay's state and outputs are the
        capture's static tensors."""
        slots = fn.reads_slots
        base = (fn_key, self._staged_id(staging, slots), _tensors_sig(fresh),
                self._state_id(state), fn.host_key(staging.shapes()))
        key = base + (acc is not None,)
        cap = self.caps.get(key)
        if cap is None and (base in self.refused
                            or self.seen.get(base, 0) < WARMUP_BLOCKS):
            self.seen[base] = self.seen.get(base, 0) + 1
            self.seen.move_to_end(base)
            if len(self.seen) > MAX_KEYS:
                self.seen.popitem(last=False)
            per_block, ev_bufs = staging.unpack()
            if fresh:
                per_block = {**per_block, **fresh}
            new_state, outs = fn(state, per_block, ev_bufs)
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
            if self.pool is None and self.device.type == "cuda":
                self.pool = (torch.cuda.graph_pool_handle(),
                             torch.cuda.Stream(self.device))
            cap = CapturedBlock(fn, self.device, state, staging, fresh,
                                acc=acc, checksum=checksum,
                                guard=self.guard, slots=slots,
                                pool=self.pool)
            self.caps[key] = cap
            if len(self.caps) > MAX_CAPTURES:
                self.caps.popitem(last=False)
            self.counts["captures"] += 1
        else:
            self.caps.move_to_end(key)
            cap.load(state, staging, fresh, acc)
        outs = cap.replay()
        self.counts["replayed"] += 1
        self._state_memo = (cap.state, base[3])
        return cap.state, outs, cap.acc, True
