"""Graph IR: nodes, connection expressions, edges, fanout shapes.

Copy of ``oscen_tpu/graph/ir.py`` (framework-free).  The Python counterpart of the reference graph compiler's IR
(/root/reference/oscen-graph-compiler/src/ir/graph.rs): ``IrNode`` instances
with declared endpoints, ``IrEdge``s whose source is a typed expression tree
(ir/expr/mod.rs:24-110), fanout shapes Scalar/Parallel/Broadcast/FanIn
(ir/graph.rs:48-78), cross-rate kernels (ir/graph.rs:31-45) and feedback
marking.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

from ..core.types import Endpoint, Kind, ParamSpec, Policy


# --------------------------------------------------------------------- #
# connection expressions
# --------------------------------------------------------------------- #
class Expr:
    """Connection-expression tree node (reference ir/expr/mod.rs).

    Built by operator overloading on endpoint references:
    ``osc.output * 0.5 + lfo.output``.
    """

    def __add__(self, other):  return BinOp("+", self, as_expr(other))
    def __radd__(self, other): return BinOp("+", as_expr(other), self)
    def __sub__(self, other):  return BinOp("-", self, as_expr(other))
    def __rsub__(self, other): return BinOp("-", as_expr(other), self)
    def __mul__(self, other):  return BinOp("*", self, as_expr(other))
    def __rmul__(self, other): return BinOp("*", as_expr(other), self)
    def __truediv__(self, other):  return BinOp("/", self, as_expr(other))
    def __rtruediv__(self, other): return BinOp("/", as_expr(other), self)
    def __neg__(self): return BinOp("-", Const(0.0), self)

    def endpoints(self) -> List["EndpointRef"]:
        """All endpoint references inside this expression."""
        out: List[EndpointRef] = []
        _collect(self, out)
        return out


def _collect(e: Expr, out: list) -> None:
    if isinstance(e, EndpointRef):
        out.append(e)
    elif isinstance(e, BinOp):
        _collect(e.lhs, out)
        _collect(e.rhs, out)
    elif isinstance(e, Call):
        for a in e.args:
            _collect(a, out)
    elif isinstance(e, FrameCtor):
        for a in e.channels:
            _collect(a, out)


def as_expr(x) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, (int, float)):
        return Const(float(x))
    raise TypeError(f"cannot use {type(x).__name__} in a connection expression")


@dataclass
class Const(Expr):
    value: float


@dataclass
class BinOp(Expr):
    op: str
    lhs: Expr
    rhs: Expr


@dataclass
class Call(Expr):
    """User-function call in a connection expression
    (reference tests/connection_expr_*.rs).  ``fn`` is any callable on torch
    tensors, applied elementwise."""
    fn: Callable
    args: Tuple[Expr, ...]


@dataclass
class FrameCtor(Expr):
    """``Frame::<N>(a, b, ...)`` — stack mono expressions into a
    multi-channel frame (trailing channel axis)."""
    channels: Tuple[Expr, ...]


@dataclass
class EndpointRef(Expr):
    """Reference to ``node.endpoint`` (optionally ``node[i].endpoint`` for
    node arrays, or ``node.out[c]`` for channel extraction)."""
    node: str            # node name, or graph input name with node == "" ?
    endpoint: str
    index: Optional[int] = None    # node-array instance index
    channel: Optional[int] = None  # channel extraction

    def __getitem__(self, c: int) -> "EndpointRef":
        if self.channel is not None:
            raise ValueError("already channel-indexed")
        return EndpointRef(self.node, self.endpoint, self.index, int(c))


class Fanout(enum.Enum):
    """Edge fanout shape (reference ir/graph.rs:48-78).

    REPEAT / SEGMENT_SUM arise only from flattening node arrays inside
    array subgraphs (the reference's nested generated structs keep the
    inner array per outer instance; flattened to one ``g*m`` axis the
    per-instance broadcast becomes a blockwise repeat and the
    per-instance fan-in a segment sum)."""
    SCALAR = "scalar"        # 1 -> 1
    PARALLEL = "parallel"    # N -> N (elementwise, min-truncated)
    BROADCAST = "broadcast"  # 1 -> N
    FAN_IN = "fan_in"        # N -> 1 (stream: sum; event: sequential copy)
    REPEAT = "repeat"        # g -> g*m: per-outer-instance broadcast
    SEGMENT_SUM = "segment_sum"  # g*m -> g: per-outer-instance fan-in


class EdgeKernel(enum.Enum):
    """Cross-rate kernel classification (reference ir/graph.rs:31-45)."""
    NONE = "none"
    UP = "up"       # outer -> inner (oversampled) edge
    DOWN = "down"   # inner -> outer edge
    EVENT_MULTIPLY = "event_multiply"  # frame-offset rescale out->in
    EVENT_DIVIDE = "event_divide"      # frame-offset rescale in->out


@dataclass
class IrNodeInst:
    """One declared node (possibly an array of ``count`` instances)."""
    name: str
    node: Any               # Node instance (graph.node.Node)
    count: int = 1          # [Ctor; N] array size (1 == scalar node)
    rate: int = 1           # * N oversampling factor (1, 2, 4, 8)
    is_graph_io: bool = False

    @property
    def is_array(self) -> bool:
        return self.count > 1


@dataclass
class IrEdge:
    source: Expr
    dst_node: str
    dst_endpoint: str
    dst_index: Optional[int] = None
    policy: Policy = Policy.DEFAULT
    kernel: EdgeKernel = EdgeKernel.NONE
    rate_factor: int = 1
    fanout: Fanout = Fanout.SCALAR
    is_feedback: bool = False
    group: int = 1   # outer array factor when flattened from an array
                     # subgraph (instance axis is (group, per-instance))
    factor: int = 1  # REPEAT/SEGMENT_SUM per-instance multiplicity
    # resolved at lowering:
    kind: Optional[Kind] = None
    src_reads_state: bool = False  # feedback edge reading prev-sample value


@dataclass
class GraphInput:
    name: str
    kind: Kind
    default: Any = 0.0
    channels: int = 1
    spec: Optional[ParamSpec] = None


@dataclass
class GraphOutput:
    name: str
    kind: Kind
    channels: int = 1


@dataclass
class IrGraph:
    name: str
    nodes: dict = field(default_factory=dict)        # name -> IrNodeInst
    edges: List[IrEdge] = field(default_factory=list)
    inputs: List[GraphInput] = field(default_factory=list)
    outputs: List[GraphOutput] = field(default_factory=list)
    output_edges: dict = field(default_factory=dict)  # out name -> Expr
    output_policies: dict = field(default_factory=dict)  # out name -> Policy
    order: List[str] = field(default_factory=list)    # topo order (all nodes)
    asset_bindings: List[tuple] = field(default_factory=list)
    # (external name, node, endpoint)

    def input_names(self) -> List[str]:
        return [i.name for i in self.inputs]

    def get_input(self, name: str) -> GraphInput:
        for i in self.inputs:
            if i.name == name:
                return i
        raise KeyError(name)
