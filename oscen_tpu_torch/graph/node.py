"""Node contract — the PyTorch ``SignalProcessor``.

Counterpart of ``oscen_tpu/graph/node.py``.  A node is a pure function over
an explicit state: a nested dict of tensors with the same keys and nesting
as the JAX package's state pytrees.

- :meth:`Node.init_state` — the ``prepare()`` analogue: build the state
  (CPU tensors; the compiler moves them to its device).
- :meth:`Node.tick` — the ``process()`` analogue: one sample.  The
  sample-mode compiler (graph/compile.py ``_SampleStep``) and the block
  compiler's scan islands call it once per sample in the reference's
  schedule.  Every tick broadcasts over a leading instance axis: a node
  array's state leaves are ``[C, ...]`` and its inputs ``[C, ...]`` (the
  JAX package ``vmap``s the scalar tick instead).
- ``on_<endpoint>(state, value, sr, ins)`` — event handlers, applied at
  the event's frame offset (:meth:`apply_events_at`).
- :meth:`Node.process_block` — the time-vectorized block implementation
  (closed forms over whole ``[B]`` blocks); the default scans :meth:`tick`
  (:func:`scan_tick_block`).  A node with ``BATCHED = True`` takes a
  leading instance axis on every state leaf, input and event buffer
  (``[C, ...]``, ``[C, B, ...]``, ``[C, K]``) in ``process_block`` too, so
  a node array of 256 voices is one call, never a Python loop over voices.

A per-sample loop owns the state it carries: it calls :meth:`own_state`
once per run and then :meth:`tick_owned`, which may write into the leaves
``own_state`` copied (the Delay's ring) instead of copying them every
sample.  The state the caller holds is never written.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..core.events import EventBuffer, EventInstance
from ..core.types import Endpoint, Kind, SampleRate

State = Dict[str, Any]
Values = Dict[str, Any]


def tree_map(fn: Callable, *trees, is_leaf=None):
    """Map ``fn`` over the leaves of nested dicts, tuples and lists of equal
    structure; containers keep their type (a resampler's state is a tuple
    of per-stage dicts, ``()`` for the stateless ones).  ``is_leaf(x)``
    true stops the descent at ``x``, as in ``jax.tree_util.tree_map``."""
    first = trees[0]
    if is_leaf is not None and is_leaf(first):
        return fn(*trees)
    if isinstance(first, dict):
        return {k: tree_map(fn, *[t[k] for t in trees], is_leaf=is_leaf)
                for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs, is_leaf=is_leaf)
                           for xs in zip(*trees))
    return fn(*trees)


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device`` without waiting for the card:
    on CUDA it is copied from pinned memory, non-blocking (a copy from
    pageable memory would wait for the card's queue first)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def select_tree(pred, on_true, on_false):
    """Elementwise tree select; ``pred`` broadcasts against each leaf from
    the left (a ``[C]`` predicate selects whole ``[C, ...]`` instances)."""
    def sel(a, b):
        p = pred
        extra = max(a.dim(), b.dim()) - p.dim()
        if extra > 0:
            p = p.reshape(tuple(p.shape) + (1,) * extra)
        return torch.where(p, a, b)
    return tree_map(sel, on_true, on_false)


class Node:
    """Base class for device-domain signal processors."""

    INPUTS: Tuple[Endpoint, ...] = ()
    OUTPUTS: Tuple[Endpoint, ...] = ()
    ALLOWS_FEEDBACK: bool = False
    HOST: bool = False
    # process_block takes a leading instance axis (see module doc)
    BATCHED: bool = False

    def input(self, name: str) -> Endpoint:
        for e in self.INPUTS:
            if e.name == name:
                return e
        raise KeyError(f"{type(self).__name__} has no input '{name}'")

    def output(self, name: str) -> Endpoint:
        for e in self.OUTPUTS:
            if e.name == name:
                return e
        raise KeyError(f"{type(self).__name__} has no output '{name}'")

    def has_input(self, name: str) -> bool:
        return any(e.name == name for e in self.INPUTS)

    def has_output(self, name: str) -> bool:
        return any(e.name == name for e in self.OUTPUTS)

    @property
    def event_inputs(self) -> List[Endpoint]:
        return [e for e in self.INPUTS if e.kind == Kind.EVENT]

    def init_state(self, sr: SampleRate) -> State:
        """Build the node's state (the ``prepare()`` analogue)."""
        return {}

    def tick(self, state: State, ins: Values, sr: SampleRate
             ) -> Tuple[State, Values]:
        """Advance one sample.  ``ins`` maps input endpoint names to
        values; returns (new_state, {output endpoint -> value})."""
        raise NotImplementedError

    def own_state(self, state: State) -> State:
        """The state a per-sample loop carries: leaves that
        :meth:`tick_owned` writes in place are copied here, once per run."""
        return state

    def tick_owned(self, state: State, ins: Values, sr: SampleRate, **kw
                   ) -> Tuple[State, Values]:
        """:meth:`tick` on a state from :meth:`own_state`; it may write
        into the leaves that copied.  ``kw``: what the compiler knows of
        the node on the host, passed where :meth:`tick` names it (the
        oscillators' ``folded_ins``, see ``graph/block_mode.py``)."""
        return self.tick(state, ins, sr, **kw)

    # ------------------------------------------------------------------ #
    # events
    # ------------------------------------------------------------------ #
    def apply_event(self, state: State, endpoint: str, value,
                    sr: SampleRate, ins: Values) -> State:
        """Invoke the ``on_<endpoint>`` handler (unmasked).  ``ins`` carries
        this sample's already-assigned input values (the reference runs the
        edge assignments before ``process_event_inputs``,
        emit_node.rs:181-362)."""
        handler = getattr(self, f"on_{endpoint}", None)
        if handler is None:
            return state
        return handler(state, value, sr, ins)

    def apply_events_at(self, state: State, endpoint: str,
                        buf: EventBuffer, t: int, sr: SampleRate,
                        ins: Values) -> State:
        """Apply every event in ``buf`` whose offset == t, in slot order,
        each under a mask (the reference's process_event_inputs dispatch,
        oscen-macros lib.rs:266-295; the JAX package's form).  The masks
        are device tensors: nothing is read back."""
        handler = getattr(self, f"on_{endpoint}", None)
        if handler is None or buf.capacity == 0:
            return state
        for k in range(buf.capacity):
            fire = torch.logical_and(buf.valid[..., k],
                                     buf.offsets[..., k] == t)
            state = select_tree(fire, handler(state, buf.values[..., k], sr,
                                              ins), state)
        return state

    def apply_events_scheduled(self, state: State, endpoint: str,
                               buf: EventBuffer, t: int, sr: SampleRate,
                               ins: Values) -> State:
        """:meth:`apply_events_at` where the host knows the events'
        offsets (``buf.slots``): the handler runs only at the slots that
        hold an event at ``t``.  A scalar node's event there fires, so its
        handler's result is taken unmasked; a node array keeps the mask
        (another instance's event may share the slot).  Both equal the
        masked form over every slot bit for bit: that form selects the old
        state wherever nothing fires."""
        if buf.slots is None:
            return self.apply_events_at(state, endpoint, buf, t, sr, ins)
        handler = getattr(self, f"on_{endpoint}", None)
        ks = buf.slots.get(t)
        if handler is None or not ks:
            return state
        array = buf.offsets.dim() > 1
        for k in ks:
            new = handler(state, buf.values[..., k], sr, ins)
            if array:
                fire = torch.logical_and(buf.valid[..., k],
                                         buf.offsets[..., k] == t)
                new = select_tree(fire, new, state)
            state = new
        return state

    def process_block(self, state: State, ins: Values,
                      events: Dict[str, EventBuffer], sr: SampleRate,
                      block_len: int) -> Tuple[State, Values]:
        """Advance one block; ``ins`` values carry a time axis ``[B, ...]``
        (after the instance axis for ``BATCHED`` nodes).  Default: the
        per-sample :meth:`tick` with the events applied at their offsets
        (:func:`scan_tick_block`) — always correct, not always fast."""
        return scan_tick_block(self, state, ins, events, sr, block_len)

    def default_inputs(self) -> Values:
        """Every stream and value input's default: a float32 0-d tensor for
        a scalar input, ``torch.full(shape or (channels,), default)``
        otherwise.  The tensors lie on the CPU (a node has no device; the
        compiler stages inputs on its own)."""
        out = {}
        for e in self.INPUTS:
            if e.kind in (Kind.STREAM, Kind.VALUE):
                d = e.default
                if e.shape or e.channels > 1:
                    shape = e.shape if e.shape else (e.channels,)
                    out[e.name] = torch.full(shape, d, dtype=torch.float32)
                else:
                    out[e.name] = torch.tensor(d, dtype=torch.float32)
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}()"


class StepValue:
    """A host-node value output that is a single step over the block:
    ``base`` before ``offset``, ``target`` from ``offset`` on.

    It stages as a ``(3[, C])`` base/target/offset tensor and is expanded
    to ``[B(, C)]`` on the device (block_mode ``reconstruct_step_values``)
    instead of a host-built ``[B, C]`` array — at 256 voices and B=1024
    that array is ~1 MB of host-to-device copy per block.
    """

    __slots__ = ("base", "offset", "target")

    def __init__(self, base: float, offset: int, target: float):
        self.base = float(base)
        self.offset = int(offset)
        self.target = float(target)

    def materialize(self, block_len: int) -> np.ndarray:
        """The equivalent host-built [B] step array."""
        arr = np.full((block_len,), np.float32(self.base), np.float32)
        arr[min(self.offset, block_len - 1):] = np.float32(self.target)
        return arr

    def __repr__(self) -> str:  # pragma: no cover
        return (f"StepValue({self.base!r}, {self.offset!r}, "
                f"{self.target!r})")


class HostNode(Node):
    """Control-rate node evaluated on the host once per block (the
    reference's event-phase nodes: MidiParser, VoiceAllocator,
    MidiVoiceHandler).  Host nodes keep mutable Python state and translate
    event lists to event lists / per-sample value arrays for the device."""

    HOST = True

    # Event-driven contract: absent input events and value changes, a
    # block's outputs reproduce verbatim, so CompiledGraph may cache the
    # steady-state staging.  Set False on a node whose outputs vary with
    # time regardless of inputs.
    HOST_STEADY = True

    def host_process(self, block_len: int,
                     events_in: Dict[str, List[EventInstance]],
                     values_in: Dict[str, float],
                     ) -> Tuple[Dict[str, List[EventInstance]],
                                Dict[str, np.ndarray]]:
        """Process one block of control data.

        Returns (event outputs by endpoint, value outputs by endpoint —
        per-sample ``[B]`` float32 arrays, block-constant ``[1]`` arrays,
        or :class:`StepValue`).  ``events_in`` sequences are read-only.  An
        event endpoint omitted from the result emits nothing this block; an
        omitted VALUE endpoint keeps its previous value.
        """
        raise NotImplementedError

    def reset(self) -> None:
        """Return host state to its initial condition."""

    def host_state(self):
        """Snapshot this node's mutable control state (for checkpointing —
        utils/checkpoint.py).  Default: a deep copy of the instance dict,
        which covers plain-Python control state (LRU voice tables, current
        note/frequency, counters)."""
        import copy
        return copy.deepcopy(self.__dict__)

    def restore_host_state(self, snapshot) -> None:
        """Restore a snapshot taken by :meth:`host_state`.  Endpoint
        declarations (INPUTS/OUTPUTS) are structural config, not runtime
        state, so they are excluded from the update."""
        import copy
        snap = {k: v for k, v in snapshot.items()
                if k not in ("INPUTS", "OUTPUTS")}
        self.__dict__.update(copy.deepcopy(snap))


def scan_tick_block(node: Node, state: State, ins: Values,
                    events: Dict[str, EventBuffer], sr: SampleRate,
                    block_len: int, taxis: int = 0
                    ) -> Tuple[State, Values]:
    """A block as ``block_len`` ticks: the counterpart of the JAX
    package's ``lax.scan`` over :meth:`Node.tick`, a Python loop over the
    samples.  ``taxis`` is the time axis of ``ins`` and of the outputs: 0
    for a scalar node, 1 for a node array (``[C, B, ...]``; its ticks
    broadcast over the instance axis, the JAX package's ``vmap``).  The
    state is owned for the block (:meth:`Node.own_state`)."""
    ev_names = sorted(k for k, b in events.items() if b.capacity > 0)
    st = node.own_state(state)
    outs: Dict[str, list] = {}
    for t in range(block_len):
        per_t = {k: v.select(taxis, t) for k, v in ins.items()}
        for name in ev_names:
            st = node.apply_events_scheduled(st, name, events[name], t, sr,
                                             per_t)
        st, o = node.tick_owned(st, per_t, sr)
        for k, v in o.items():
            outs.setdefault(k, []).append(v)
    return st, {k: torch.stack(v, dim=taxis) for k, v in outs.items()}


def apply_node_events(node: Node, state: State, name: str,
                      ev_bufs: Dict[str, EventBuffer], t: int,
                      sr: SampleRate, ins: Values) -> State:
    """Every event of the event inputs of graph node ``name`` at sample
    ``t``, in endpoint order (the reference's process_event_inputs), where
    the host staged them (:meth:`Node.apply_events_scheduled`)."""
    for ep in node.INPUTS:
        if ep.kind != Kind.EVENT:
            continue
        buf = ev_bufs.get(f"{name}.{ep.name}")
        if buf is not None and buf.capacity > 0:
            state = node.apply_events_scheduled(state, ep.name, buf, t, sr,
                                                ins)
    return state
