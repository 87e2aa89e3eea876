"""Run-time introspection of kernel/fast-path selection.

Counterpart of ``oscen_tpu/graph/explain.py``.  Which node runs a fused
kernel, which runs as a batched block, and whether the voice mix-down was
fused into the producer's kernel are decisions block_mode makes while it
runs a block; nodes record them here as a side effect.
``CompiledGraph.explain()`` runs one block on a copy of the state inside
``recording()`` and returns the notes.

Usage from node/op code (no-op unless a recording is active)::

    from ..graph import explain
    explain.note(kernel="additive_voice_v4", fanin_mixdown_fused=True)

The ``node`` field is filled automatically from the surrounding
``processing(name)`` scope that block_mode enters per node.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, List, Optional

_REC: Optional[List[Dict[str, Any]]] = None
_NODE: Optional[str] = None


def active() -> bool:
    """True while an explain() run is recording."""
    return _REC is not None


@contextmanager
def recording(out: List[Dict[str, Any]]):
    """Collect notes emitted during the enclosed run into ``out``."""
    global _REC
    prev, _REC = _REC, out
    try:
        yield out
    finally:
        _REC = prev


@contextmanager
def processing(name: str):
    """Scope marking which graph node is currently running."""
    global _NODE
    if _REC is None:
        yield
        return
    prev, _NODE = _NODE, name
    try:
        yield
    finally:
        _NODE = prev


def note(**facts: Any) -> None:
    """Record one fact dict against the current node."""
    if _REC is None:
        return
    entry = dict(facts)
    entry.setdefault("node", _NODE)
    _REC.append(entry)


def format_report(entries: List[Dict[str, Any]]) -> str:
    """Human-readable rendering of explain() entries."""
    lines = []
    for e in entries:
        node = e.get("node") or "<graph>"
        rest = {k: v for k, v in e.items() if k != "node"}
        kv = ", ".join(f"{k}={v}" for k, v in rest.items())
        lines.append(f"{node}: {kv}")
    return "\n".join(lines)
