"""Carry state between the JAX package and the port.

A JAX ``CompiledGraph.state`` mapped to numpy
(``jax.tree_util.tree_map(np.asarray, c.state)``) is a nested dict of
arrays, tuples and lists; the port's state has the same keys, nesting and
container types.  These tree maps keep key names, shapes and dtypes (the
piano's ``step`` int32 and ``released`` bool, the ADSR's ``stage``,
``rem``, ``age`` and ``stage_len`` int32 — ``[C, N]`` in an ``AdsrBank``
array — the FM chains' ``phases`` and ``prevs`` ``[C, 3]``, the
``Delay``'s ``write_pos`` and ``frame_counter`` int32, the rest float32),
including the feedback carries ``__fb__`` and the resampler states
``__rs__``: a tuple of per-stage dicts per cross-rate edge (the IIR
halfband's histories are tuples of per-allpass rows), ``()`` for the
latch and the linear down.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..graph.compile import resolve_device
from ..graph.node import tree_map


def state_from_jax(np_state: Any, device="cuda") -> Any:
    """Numpy state (from the JAX package) -> torch state on ``device``:
    the CUDA card by default (without a card this raises), or ``"cpu"``."""
    dev = resolve_device(device)
    # the JAX package's states nest dicts and tuples; a list there is an
    # array value (``np.asarray`` of it), not a container
    return tree_map(lambda x: torch.tensor(np.asarray(x), device=dev),
                    np_state, is_leaf=lambda x: isinstance(x, list))


def state_to_numpy(state: Any) -> Any:
    """Torch state -> numpy state, e.g. to compare with the JAX package.
    A voice-sharded state's ``DTensor`` leaves give their whole value, as
    ``np.asarray`` gathers a JAX array's shards: a collective, so every
    rank of the mesh calls it."""
    return tree_map(lambda x: _whole(x).detach().cpu().numpy(), state)


def _whole(x):
    full = getattr(x, "full_tensor", None)   # a DTensor
    return x if full is None else full()
