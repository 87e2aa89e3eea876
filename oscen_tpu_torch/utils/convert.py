"""Carry state between the JAX package and the port.

A JAX ``CompiledGraph.state`` mapped to numpy
(``jax.tree_util.tree_map(np.asarray, c.state)``) is a nested dict of
arrays; the port's state has the same keys and nesting.  These tree maps
keep key names and dtypes (``step`` int32, ``released`` bool, the rest
float32).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..graph.node import tree_map


def state_from_jax(np_state: Any, device="cpu") -> Any:
    """Numpy state (from the JAX package) -> torch state on ``device``."""
    return tree_map(lambda x: torch.tensor(np.asarray(x), device=device),
                    np_state)


def state_to_numpy(state: Any) -> Any:
    """Torch state -> numpy state, e.g. to compare with the JAX package."""
    return tree_map(lambda x: x.detach().cpu().numpy(), state)
