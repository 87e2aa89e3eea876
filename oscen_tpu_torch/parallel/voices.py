"""Voice-axis sharding over processes, one per device.

Counterpart of ``oscen_tpu/parallel/voices.py``.  The JAX package shards a
graph's voice axis over a device mesh from one controller (``shard_map``,
with a ``psum`` for the mix).  Here the form is PyTorch's SPMD one: one
process per device, a one-dimensional ``DeviceMesh`` with a ``"voices"``
dimension, ``DTensor`` placements ``Shard(0)`` / ``Replicate()`` for the
state, and ``torch.distributed.all_reduce`` (SUM) over the mesh's group
wherever the JAX package psums.

Every rank runs the same host control plane: every rank queues the same
events and sets the same values, and MIDI parsing, voice allocation and
staging are deterministic, so the ranks agree.  In block mode each rank
stages only its slice of every node array's per-voice arrays, runs the
block function on its local instances (``count // n``: its kernels launch
at the local voice count) and all-reduces the partial mixes, so each rank's
``process_block()`` returns the full outputs, as the JAX package's
``out_specs=P()`` does.  In sample mode (where the JAX package places the
state and lets GSPMD insert the collectives) each rank all-gathers the
sharded leaves at the start of a block, runs the unsharded per-sample step
and keeps its slice at the end: the outputs equal the unsharded render's
bit for bit.

Launch N ranks with ``torchrun --nproc-per-node N script.py`` (then
``voice_mesh()`` initializes the default group from the launcher's
environment), or with ``torch.multiprocessing.spawn`` and
``torch.distributed.init_process_group`` called first (a ``FileStore``
needs no network port).  The backend is NCCL on the card, one process per
card; gloo on the CPU.  NCCL refuses two ranks on one card, so two ranks
that share a card initialize a gloo group themselves (gloo all-reduces a
card's tensors through the host, and waits for the card).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

__all__ = ["voice_mesh", "voice_sharding", "shard_compiled_state"]


def _dtensor():
    """``(DTensor, Replicate, Shard)`` from this PyTorch's module."""
    try:
        from torch.distributed.tensor import DTensor, Replicate, Shard
    except ImportError:   # PyTorch before 2.4
        from torch.distributed._tensor import DTensor, Replicate, Shard
    return DTensor, Replicate, Shard


def voice_mesh(n_devices: Optional[int] = None, axis_name: str = "voices",
               device="cuda"):
    """A one-dimensional ``DeviceMesh`` over every rank of the default
    process group, its dimension named ``axis_name``.  Without an
    initialized group it initializes one from the launcher's environment
    (``torchrun``), as ``init_device_mesh`` does: NCCL for ``"cuda"``, gloo
    for ``"cpu"``.  ``n_devices``, if given, must equal the world size.
    Nothing here switches the backend or the device."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    kind = torch.device(device).type
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"voice_mesh({n_devices}): the process group has "
                         f"{world} ranks; run one process per device")
    return DeviceMesh(kind, list(range(world)), mesh_dim_names=(axis_name,))


def voice_sharding(mesh=None, axis_name: str = "voices"):
    """The placement of a voice-sharded leaf: ``Shard(0)`` on the mesh's
    one dimension (the JAX package's ``NamedSharding(mesh, P(axis))``)."""
    return _dtensor()[2](0)


def shard_compiled_state(compiled, mesh, voice_nodes: Optional[
        Iterable[str]] = None, axis_name: str = "voices"):
    """Shard a ``CompiledGraph``'s voice axis over ``mesh``: this rank keeps
    its slice of every node-array state leaf whose leading axis is the
    node's count, where the mesh divides the count, and a copy of the rest.
    ``compiled.state`` then reads as ``DTensor``s (``Shard(0)`` /
    ``Replicate()``) built without a collective.

    In block mode this also switches execution to SPMD
    (``CompiledGraph.enable_sharding``), and, as the JAX package's
    ``shard_map`` in-specs do, shards every such node array: ``voice_nodes``
    narrows the sharded nodes in sample mode only, where the per-sample step
    runs on the gathered state."""
    if compiled.mode == "block":
        compiled.enable_sharding(mesh, axis_name)
        voice_nodes = None
    else:
        compiled._set_shard(VoiceShard(mesh, axis_name))
    compiled._shard_state(voice_nodes)
    return compiled


class VoiceShard:
    """One rank's part of a voice mesh: its slices of the state and the
    staging, the gathers of sample mode, the ``DTensor`` view of the state.
    ``CompiledGraph`` holds one once sharded; the block function
    all-reduces over ``group``."""

    def __init__(self, mesh, axis_name: str = "voices"):
        self.mesh, self.axis = mesh, axis_name
        self.group = mesh.get_group(axis_name)
        self.n = int(mesh.size())
        self.rank = int(mesh.get_local_rank(axis_name))

    def divides(self, count: int) -> bool:
        return count > 1 and count % self.n == 0

    def take(self, x, count: int, axis: int = 0):
        """This rank's slice of ``x`` (numpy or tensor) along ``axis``,
        whose length is ``count``."""
        k = count // self.n
        lo = self.rank * k
        if isinstance(x, torch.Tensor):
            return x.narrow(axis, lo, k).clone()
        return np.ascontiguousarray(
            x[(slice(None),) * axis + (slice(lo, lo + k),)])

    def split(self, state: Dict[str, Any], counts: Dict[str, int]
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``(this rank's state, a tree of bools: sharded leaves)`` of a
        full state: the leaves of node ``name`` (``__fb__`` carries by their
        key's node) whose leading axis is ``counts[name]``."""
        from ..graph.node import tree_map

        def flag(name):
            c = counts.get(name)
            return lambda x: c is not None and x.dim() >= 1 \
                and x.shape[0] == c

        # "__fb__" keys are "<node>.<endpoint>": node names may hold dots,
        # endpoint names never do
        flags = {name: ({k: flag(k.rsplit(".", 1)[0])(v)
                         for k, v in sub.items()} if name == "__fb__"
                        else tree_map(flag(name), sub))
                 for name, sub in state.items()}
        local = {}
        for name, sub in state.items():
            if name == "__fb__":
                local[name] = {k: (self.take(v, counts[k.rsplit(".", 1)[0]])
                                   if flags[name][k] else v)
                               for k, v in sub.items()}
            else:
                local[name] = tree_map(
                    lambda x, on, c=counts.get(name):
                    self.take(x, c) if on else x, sub, flags[name])
        return local, flags

    def gather(self, state, flags):
        """The full state from every rank's slices (one all-gather per
        sharded leaf)."""
        import torch.distributed as dist
        from ..graph.node import tree_map

        def one(x, on):
            if not on:
                return x
            parts = [torch.empty_like(x) for _ in range(self.n)]
            dist.all_gather(parts, x.contiguous(), group=self.group)
            return torch.cat(parts, 0)
        return tree_map(one, state, flags)

    def dtensors(self, state, flags):
        """The state as ``DTensor``s on the mesh, from the local tensors
        (``run_check=False``: no collective)."""
        DTensor, Replicate, Shard = _dtensor()
        from ..graph.node import tree_map
        return tree_map(lambda x, on: DTensor.from_local(
            x, self.mesh, [Shard(0) if on else Replicate()],
            run_check=False), state, flags)

