"""Checkpoint / resume for compiled graphs.

Counterpart of ``oscen_tpu/utils/checkpoint.py``.  The engine state has
three parts, all saved: the device state (node states, feedback carries,
resampler histories, ring buffers, FDL spectra) as numpy arrays, the host
parameter/ramp state, and the host-domain control state (voice-allocator
LRU tables, MIDI note tracking, pending events).  A restore goes onto the
graph's own device, checks the state's structure and leaf shapes, and
continues bit for bit.

A checkpoint of the JAX package does not load here (its pickles name the
JAX package's classes: event payloads, host nodes); carry JAX state across
with ``utils.convert.state_from_jax``.
"""

from __future__ import annotations

import pickle

import numpy as np

from .convert import state_from_jax, state_to_numpy


def _host_node_instances(compiled, name):
    insts = compiled.prog.host_instances.get(name)
    if insts is None:
        insts = [compiled.ir.nodes[name].node]
    return insts


def _structure(tree):
    """The container skeleton of a state (keys in sorted order, as
    ``jax.tree_util`` orders them, container types, leaf positions),
    comparable with ``==``."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k]))
                              for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return "*"


def _leaves(tree):
    """The leaves in the order of :func:`_structure`."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def save_state(compiled, path: str) -> None:
    """Serialize a CompiledGraph's device state (plus host param/ramp and
    host-domain control state) to ``path``.  A voice-sharded graph's state
    is gathered whole first, so every rank calls this, each with its own
    ``path``; the files are equal."""
    host_params = {
        name: {"current": float(r.current), "target": float(r.target),
               "increment": float(r.increment),
               "frames_remaining": int(r.frames_remaining)}
        for name, r in compiled._params.items()}
    host_nodes = {
        name: [inst.host_state()
               for inst in _host_node_instances(compiled, name)]
        for name in compiled.prog.host_nodes}
    pending_events = {
        name: [(int(e.frame_offset), e.payload) for e in q]
        for name, q in compiled._event_queues.items()}
    blob = {
        "state": state_to_numpy(compiled.state),
        "params": host_params,
        "host_nodes": host_nodes,
        "pending_events": pending_events,
        "sample_rate": compiled.sample_rate,
        "graph": compiled.ir.name,
    }
    with open(path, "wb") as f:
        pickle.dump(blob, f)


def load_state(compiled, path: str) -> None:
    """Restore state saved by :func:`save_state` into ``compiled``, on its
    device.  Graph name, sample rate, state structure and leaf shapes must
    match.  A voice-sharded graph checks the whole shapes and keeps its
    slices (the ``state`` setter)."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if blob["graph"] != compiled.ir.name:
        raise ValueError(
            f"checkpoint is for graph '{blob['graph']}', not "
            f"'{compiled.ir.name}'")
    if blob["sample_rate"] != compiled.sample_rate:
        raise ValueError("sample rate mismatch")
    # a checkpoint from a graph compiled with another voice count or node
    # config must fail, not load wrong-shaped leaves
    cur_struct = _structure(compiled.state)
    new_struct = _structure(blob["state"])
    if cur_struct != new_struct:
        raise ValueError(
            "checkpoint state tree does not match this compiled graph")
    for cur, new in zip(_leaves(compiled.state), _leaves(blob["state"])):
        if tuple(cur.shape) != np.shape(new):
            raise ValueError(
                "checkpoint leaf shape mismatch "
                f"({np.shape(new)} vs {tuple(cur.shape)}) — was the graph "
                "compiled with a different voice count or block config?")
    compiled.state = state_from_jax(blob["state"], compiled.device)
    for name, p in blob["params"].items():
        r = compiled._params.get(name)
        if r is None:
            continue
        r.current = np.float32(p["current"])
        r.target = np.float32(p["target"])
        r.increment = np.float32(p["increment"])
        r.frames_remaining = int(p["frames_remaining"])
        # restored params stage as runtime data (the checkpoint does not
        # record whether they were ever set)
        r.touched = True
    for name, snapshots in blob.get("host_nodes", {}).items():
        if name not in compiled.prog.host_set:
            continue
        insts = _host_node_instances(compiled, name)
        if len(insts) != len(snapshots):
            raise ValueError(
                f"checkpoint has {len(snapshots)} snapshots for host "
                f"node '{name}' but the graph has {len(insts)} "
                "instances — voice counts must match")
        for inst, snap in zip(insts, snapshots):
            inst.restore_host_state(snap)
    # the host mirrors (the Convolver's fade position) from the saved
    # arrays: no read of the card
    for name in compiled._mirrors:
        st = blob["state"][name]
        compiled._mirrors[name] = {
            k: int(np.asarray(st[k]).reshape(-1)[0])
            for k in compiled.ir.nodes[name].node.HOST_MIRROR}
    # restored host state invalidates the per-instance steady memo and
    # any staging built from the pre-restore state
    compiled._host_steady.clear()
    compiled._staging_cache.clear()
    compiled._touch()
    if "pending_events" in blob:
        from ..core.events import EventInstance
        for q in compiled._event_queues.values():
            q.clear()
        for name, evs in blob["pending_events"].items():
            q = compiled._event_queues.get(name)
            if q is None:
                continue
            q.extend(EventInstance(off, payload) for off, payload in evs)
