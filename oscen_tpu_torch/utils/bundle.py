"""Deployable model bundles: a compiled graph plus its state.

Counterpart of ``oscen_tpu/utils/bundle.py`` (the build-tooling analogue of
the reference's ``xtask bundle``).  A bundle directory holds the lowered
IR, the full engine checkpoint (device state including published assets,
host params and ramps, control state, pending events) and a manifest, and
loads back into a ready-to-render :class:`CompiledGraph` with no
model-building code::

    manifest.json   name, sample rate, block size, mode, I/O table,
                    node inventory, param specs (the nih_params export)
    ir.pkl          the lowered IR (library node instances pickle;
                    custom nodes need their class importable)
    state.pkl       full checkpoint (utils/checkpoint.py format)

Use: build, voice and play on a dev box, ``save_bundle(synth, path)``,
ship the directory, ``synth = load_bundle(path)`` in the serving process
(on the CUDA card unless ``device="cpu"``).  Restores are bit-exact (the
checkpoint's guarantee).  A bundle of the JAX package does not load here:
its pickles name the JAX package's classes.
"""

from __future__ import annotations

import json
import os
import pickle

from .checkpoint import load_state, save_state

_FORMAT = 1


def save_bundle(compiled, path: str) -> None:
    """Write ``compiled`` (a CompiledGraph) as a bundle directory."""
    os.makedirs(path, exist_ok=True)
    manifest = {
        "format": _FORMAT,
        "graph": compiled.ir.name,
        "sample_rate": compiled.sample_rate,
        "block_size": compiled.block_size,
        "mode": compiled.mode,
        "inputs": [{"name": i.name, "kind": i.kind.name.lower(),
                    "default": getattr(i, "default", None)}
                   for i in compiled.ir.inputs],
        "outputs": [{"name": o.name, "kind": o.kind.name.lower(),
                     "channels": getattr(o, "channels", 1)}
                    for o in compiled.ir.outputs],
        "nodes": sorted(
            {f"{type(inst.node).__name__}"
             + (f"[{inst.count}]" if inst.count > 1 else "")
             for inst in compiled.ir.nodes.values()}),
        "params": {
            name: {"min": spec.min, "max": spec.max, "log": spec.log,
                   "unit": spec.unit, "step": spec.step,
                   "display_name": spec.display_name}
            for name, spec in _param_specs(compiled).items()},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, default=float)
    with open(os.path.join(path, "ir.pkl"), "wb") as f:
        pickle.dump(compiled.ir, f)
    save_state(compiled, os.path.join(path, "state.pkl"))


def _param_specs(compiled):
    out = {}
    for gi in compiled.ir.inputs:
        spec = getattr(gi, "spec", None)
        if spec is not None:
            out[gi.name] = spec
    return out


def load_bundle(path: str, jit: bool = True, device="cuda"):
    """Reconstruct a ready-to-render CompiledGraph from a bundle, on
    ``device`` (the CUDA card by default; without a card this raises).
    ``jit`` is accepted for the JAX package's signature and has no
    meaning here: the port runs its block functions eagerly."""
    from ..graph.compile import CompiledGraph

    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != _FORMAT:
        raise ValueError(f"unknown bundle format {manifest.get('format')}")
    with open(os.path.join(path, "ir.pkl"), "rb") as f:
        ir = pickle.load(f)
    compiled = CompiledGraph(ir, sample_rate=manifest["sample_rate"],
                             block_size=manifest["block_size"],
                             mode=manifest["mode"], device=device)
    load_state(compiled, os.path.join(path, "state.pkl"))
    return compiled


__all__ = ["save_bundle", "load_bundle"]
