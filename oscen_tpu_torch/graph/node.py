"""Node contract — the PyTorch ``SignalProcessor``.

Counterpart of ``oscen_tpu/graph/node.py``.  A node is a pure function over
an explicit state: a nested dict of tensors with the same keys and nesting
as the JAX package's state pytrees.

- :meth:`Node.init_state` — the ``prepare()`` analogue: build the state
  (CPU tensors; the compiler moves them to its device).
- ``on_<endpoint>(state, value, sr, ins)`` — event handlers.
- :meth:`Node.process_block` — the time-vectorized block implementation
  (closed forms over whole ``[B]`` blocks).  A node with ``BATCHED = True``
  takes a leading instance axis on every state leaf, input and event
  buffer (``[C, ...]``, ``[C, B, ...]``, ``[C, K]``), so a node array of
  256 voices is one call, never a Python loop over voices.

Sample mode (the per-sample ``tick`` schedule) is not part of the port yet.
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

    def process_block(self, state: State, ins: Values,
                      events: Dict[str, EventBuffer], sr: SampleRate,
                      block_len: int) -> Tuple[State, Values]:
        """Advance one block; ``ins`` values carry a time axis ``[B, ...]``
        (after the instance axis for ``BATCHED`` nodes)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no block implementation in the "
            f"port yet (ROADMAP.md queue 1)")

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
