"""Graph builder — the ``graph!`` DSL as a Python API.

Counterpart of ``oscen_tpu/graph/builder.py``.  The reference compiles a
declarative synth description at Rust compile time (oscen-graph-compiler:
parse → lower → dead_nodes → codegen).  Here the same pipeline runs at
Python level and "codegen" produces a block function over torch tensors
on one device (see :mod:`oscen_tpu_torch.graph.compile`).

Semantics mirrored from the reference lowering (ir/lower.rs):

- typed inputs/outputs with defaults and param specs,
- node declarations with array counts (``[Ctor; N]``) and rates (``* N``),
- connection statements with expression sources, policies and delay vias
  (``src -> [16] -> dst`` == ``connect(src, dst, via=16)``),
- stream fan-in summing (first edge connects, later edges accumulate,
  static_context.rs:160-217), event fan-in last-write-wins,
- Kahn topological sort skipping feedback edges (lower.rs:1015-1085),
- dead-node elimination by reverse reachability from outputs
  (ir/passes/dead_nodes.rs),
- cross-rate kind validation: (S,S), (V,V), (V,S), (E,E) only
  (lower.rs:1099-1165).
"""

from __future__ import annotations

import functools

from typing import Dict, List, Optional, Union

import torch

from ..core.types import Kind, ParamSpec, Policy
from .ir import (BinOp, Call, Const, EdgeKernel, EndpointRef, Expr, Fanout,
                 FrameCtor, GraphInput, GraphOutput, IrEdge, IrGraph,
                 IrNodeInst, as_expr)
from .node import Node

__all__ = ["Graph", "GraphError", "NodeRef", "Frame", "call"]


def _repeat_instances(k: int, v):
    """Group-alignment helper: duplicate each instance ``k`` times along
    the leading (instance) axis — per-outer-instance broadcast for
    expressions flattened out of array subgraphs."""
    return torch.repeat_interleave(v, k, dim=0)


class GraphError(ValueError):
    """Graph compilation diagnostic (the compile_error! analogue)."""


class NodeRef:
    """Handle for a declared node; attribute access yields endpoint refs."""

    def __init__(self, graph: "Graph", name: str):
        object.__setattr__(self, "_graph", graph)
        object.__setattr__(self, "_name", name)

    @property
    def name(self) -> str:
        return self._name

    def __getattr__(self, endpoint: str) -> EndpointRef:
        if endpoint.startswith("_"):
            raise AttributeError(endpoint)
        self._graph._check_endpoint(self._name, endpoint)
        return EndpointRef(self._name, endpoint)

    def __getitem__(self, i: int) -> "NodeInstanceRef":
        return NodeInstanceRef(self._graph, self._name, int(i))

    def __repr__(self):
        return f"NodeRef({self._name!r})"


class NodeInstanceRef:
    """``voices[3]`` — one element of a node array."""

    def __init__(self, graph: "Graph", name: str, index: int):
        self._graph = graph
        self._name = name
        self._index = index

    def __getattr__(self, endpoint: str) -> EndpointRef:
        if endpoint.startswith("_"):
            raise AttributeError(endpoint)
        self._graph._check_endpoint(self._name, endpoint)
        return EndpointRef(self._name, endpoint, index=self._index)


def InputRef(name: str) -> EndpointRef:
    """Reference to a graph input: an endpoint of the pseudo-node ''.
    Usable directly inside connection expressions."""
    return EndpointRef("", name)


def Frame(*channels) -> FrameCtor:
    """``Frame::<N>(a, b)`` constructor for multi-channel edges."""
    return FrameCtor(tuple(as_expr(c) for c in channels))


def call(fn, *args) -> Call:
    """User-function call in a connection expression."""
    return Call(fn, tuple(as_expr(a) for a in args))


class Graph:
    """Declarative graph description + lowering."""

    def __init__(self, name: str = "Graph"):
        self.name = name
        self._inputs: List[GraphInput] = []
        self._outputs: List[GraphOutput] = []
        self._nodes: Dict[str, IrNodeInst] = {}
        self._connections: List[dict] = []  # raw stmts, lowered later
        self._output_sources: Dict[str, Expr] = {}
        self._synth_counter = 0
        self._via_used: set = set()
        self._externals: set = set()
        self._asset_bindings: List[tuple] = []  # (external, node, endpoint)

    # ------------------------------------------------------------------ #
    # declarations
    # ------------------------------------------------------------------ #
    def input(self, name: str, kind: Union[str, Kind] = Kind.VALUE,
              default: float = 0.0, channels: int = 1,
              spec: Optional[ParamSpec] = None, ramp: int = 0) -> InputRef:
        kind = Kind(kind) if not isinstance(kind, Kind) else kind
        if any(i.name == name for i in self._inputs):
            raise GraphError(f"duplicate input '{name}'")
        if ramp:
            spec = spec or ParamSpec()
            spec.ramp_frames = int(ramp)
        self._inputs.append(GraphInput(name, kind, default, channels, spec))
        return InputRef(name)

    def output(self, name: str, kind: Union[str, Kind] = Kind.STREAM,
               channels: int = 1) -> str:
        kind = Kind(kind) if not isinstance(kind, Kind) else kind
        if any(o.name == name for o in self._outputs):
            raise GraphError(f"duplicate output '{name}'")
        self._outputs.append(GraphOutput(name, kind, channels))
        return name

    def external(self, name: str) -> str:
        """Declare an external asset slot (reference ``external name:
        Type;``, ast.rs + lower.rs asset-binding pre-pass).  Bind it to a
        node's asset input with ``connect(name, node.asset_endpoint)``;
        publish into it at run time with ``CompiledGraph.publish_asset`` or
        ``load_wav``."""
        if name in self._externals or name in self._nodes:
            raise GraphError(f"duplicate external '{name}'")
        self._externals.add(name)
        return name

    def add(self, name: str, node, count: int = 1,
            rate: int = 1) -> NodeRef:
        """Declare a node: ``name = Ctor`` / ``[Ctor; count]`` / ``* rate``.
        ``node`` may be another :class:`Graph` (nested graphs, reference
        tests/nested_graph_test.rs) — it is inlined at lowering with
        prefixed names and composed counts/rates."""
        if name in self._nodes or any(i.name == name for i in self._inputs):
            raise GraphError(f"duplicate node name '{name}'")
        if rate not in (1, 2, 4, 8):
            raise GraphError(f"node rate must be 1, 2, 4 or 8 (got {rate})")
        if not isinstance(node, (Node, Graph)):
            raise GraphError(
                f"'{name}' is not a Node or Graph "
                f"(got {type(node).__name__})")
        self._nodes[name] = IrNodeInst(name, node, int(count), int(rate))
        return NodeRef(self, name)

    # ------------------------------------------------------------------ #
    # connections
    # ------------------------------------------------------------------ #
    def connect(self, source, dest, policy: Union[str, Policy] = Policy.DEFAULT,
                via: Optional[Union[int, str, NodeRef]] = None,
                feedback: bool = False) -> None:
        """``source -> dest`` (optionally ``-> [via] ->``).

        ``feedback=True`` marks the edge as cycle-breaking: the destination
        (or a source) must be a feedback-capable node (AllowsFeedback —
        ≥ 1 sample of inherent delay, like Delay).  The edge then reads the
        source's previous-sample value when the source sorts after the
        destination, exactly like the reference's generated code reading a
        stale struct field.
        """
        policy = Policy(policy) if not isinstance(policy, Policy) else policy
        if isinstance(source, str) and (
                source in self._externals
                or any(i.name == source and i.kind == Kind.ASSET
                       for i in self._inputs)):
            # asset binding, not a signal edge (lower.rs:375-425).  The
            # source is an external slot or this graph's own asset-kind
            # input (the nested-graph forwarding handle); the destination
            # is a node's asset input or a subgraph's asset-kind input.
            key = (source if source in self._externals
                   else ("__input__", source))
            dst = self._as_dest(dest)
            if not isinstance(dst, EndpointRef):
                raise GraphError(
                    f"external '{source}' can only bind to a node's asset "
                    f"input")
            node = self._nodes[dst.node].node
            if isinstance(node, Graph):
                gi = next((i for i in node._inputs
                           if i.name == dst.endpoint), None)
                if gi is None or gi.kind != Kind.ASSET:
                    raise GraphError(
                        f"external '{source}' must bind to an asset input "
                        f"of subgraph '{dst.node}', not '{dst.endpoint}'")
            elif node.input(dst.endpoint).kind != Kind.ASSET:
                raise GraphError(
                    f"external '{source}' must bind to an asset input, "
                    f"not '{dst.node}.{dst.endpoint}'")
            self._asset_bindings.append((key, dst.node, dst.endpoint))
            return
        src = self._as_source_expr(source)
        dst = self._as_dest(dest)
        if feedback and via is not None:
            raise GraphError("use either feedback=True or via=, not both")
        self._connections.append(
            {"src": src, "dst": dst, "policy": policy, "via": via,
             "feedback": bool(feedback)})

    def _as_source_expr(self, source) -> Expr:
        if isinstance(source, str):
            # graph input name or "node.endpoint"
            if "." in source:
                node, ep = source.split(".", 1)
                self._check_endpoint(node, ep)
                return EndpointRef(node, ep)
            if any(i.name == source for i in self._inputs):
                return EndpointRef("", source)
            raise GraphError(f"unknown connection source '{source}'")
        if isinstance(source, (int, float)):
            return Const(float(source))
        if isinstance(source, Expr):
            return source
        raise GraphError(f"bad connection source {source!r}")

    def _as_dest(self, dest):
        if isinstance(dest, EndpointRef):
            return dest
        if isinstance(dest, str):
            if "." in dest:
                node, ep = dest.split(".", 1)
                self._check_endpoint(node, ep)
                return EndpointRef(node, ep)
            if any(o.name == dest for o in self._outputs):
                return ("__output__", dest)
            raise GraphError(f"unknown connection destination '{dest}'")
        raise GraphError(f"bad connection destination {dest!r}")

    def _check_endpoint(self, node: str, endpoint: str) -> None:
        if node not in self._nodes:
            raise GraphError(f"unknown node '{node}'")
        n = self._nodes[node].node
        if isinstance(n, Graph):
            if not (any(i.name == endpoint for i in n._inputs)
                    or any(o.name == endpoint for o in n._outputs)):
                raise GraphError(
                    f"subgraph '{node}' ({n.name}) has no input/output "
                    f"'{endpoint}'")
            return
        if not (n.has_input(endpoint) or n.has_output(endpoint)):
            raise GraphError(
                f"node '{node}' ({type(n).__name__}) has no endpoint "
                f"'{endpoint}'")

    # ------------------------------------------------------------------ #
    # subgraph flattening (nested graphs)
    # ------------------------------------------------------------------ #
    def _flatten(self) -> "Graph":
        """Inline nested Graph nodes: prefixed inner nodes, composed
        counts/rates, graph-input substitution, output-expression
        inlining.  Semantically equivalent to the reference's nested
        generated structs (the inner schedule is a straight inline of the
        same dataflow)."""
        subs = {n: i for n, i in self._nodes.items()
                if isinstance(i.node, Graph)}
        if not subs:
            return self

        sub_flat: Dict[str, Graph] = {
            n: i.node._flatten() for n, i in subs.items()}

        f = Graph(self.name)
        f._inputs = list(self._inputs)
        f._outputs = list(self._outputs)
        f._externals = set(self._externals)

        # asset bindings: resolve bindings into subgraph asset inputs
        # through the subgraph's own (already-flattened) binding list,
        # and lift inner bindings (reference asset wiring is generic
        # over nesting, asset/mod.rs:309-320)
        consumed_inner: set = set()   # (sub, input_name) satisfied
        for b in self._asset_bindings:
            ext, node, ep = b
            if node not in subs:
                f._asset_bindings.append(b)
                continue
            matches = [ib for ib in sub_flat[node]._asset_bindings
                       if ib[0] == ("__input__", ep)]
            if not matches:
                raise GraphError(
                    f"subgraph '{node}' has no asset route from its "
                    f"input '{ep}' (connect the input to a node's asset "
                    f"endpoint inside the subgraph)")
            consumed_inner.add((node, ep))
            for (_, inode, iep) in matches:
                f._asset_bindings.append((ext, f"{node}.{inode}", iep))
        for sub_name in subs:
            for (iext, inode, iep) in sub_flat[sub_name]._asset_bindings:
                if isinstance(iext, tuple):
                    if (sub_name, iext[1]) not in consumed_inner:
                        raise GraphError(
                            f"asset input '{iext[1]}' of subgraph "
                            f"'{sub_name}' is unbound; connect an "
                            f"external (or an outer asset input) to it")
                    continue
                # subgraph-declared external: re-export prefixed
                f._externals.add(f"{sub_name}.{iext}")
                f._asset_bindings.append(
                    (f"{sub_name}.{iext}", f"{sub_name}.{inode}", iep))

        # nodes
        for name, inst in self._nodes.items():
            if name in subs:
                sub = sub_flat[name]
                for iname, iinst in sub._nodes.items():
                    rate = inst.rate * iinst.rate
                    if rate not in (1, 2, 4, 8):
                        raise GraphError(
                            f"composed rate {rate}x on '{name}.{iname}' "
                            f"out of range")
                    f._nodes[f"{name}.{iname}"] = IrNodeInst(
                        f"{name}.{iname}", iinst.node,
                        inst.count * iinst.count, rate)
            else:
                f._nodes[name] = IrNodeInst(name, inst.node, inst.count,
                                            inst.rate)

        def sub_input(sub_name: str, in_name: str) -> GraphInput:
            return sub_flat[sub_name].get_input_decl(in_name)

        def sub_output_expr(sub_name: str, out_name: str) -> Expr:
            sub = sub_flat[sub_name]
            srcs = [s["src"] for s in sub._connections
                    if isinstance(s["dst"], tuple)
                    and s["dst"][1] == out_name]
            if not srcs:
                return Const(0.0)
            expr = srcs[0]
            for s in srcs[1:]:
                expr = BinOp("+", expr, s)
            return expr

        # outer stmts targeting subgraph inputs.  A delay via on such a
        # stmt is synthesized here at the flattened level (the reference
        # handles this inside its generic via lowering, lower.rs:509-655):
        # src -> Delay.input, and the substituted input reads
        # Delay.output through a feedback-marked edge.
        outer_into: Dict[tuple, list] = {}
        passthrough: List[dict] = []
        _via_ctr = [0]
        for stmt in self._connections:
            dst = stmt["dst"]
            if isinstance(dst, EndpointRef) and dst.node in subs:
                via = stmt.get("via")
                if via is not None:
                    if isinstance(via, NodeRef):
                        via = via.name
                    if isinstance(via, str):
                        if via in subs:
                            raise GraphError(
                                f"via node '{via}' cannot be a subgraph")
                        if via not in self._nodes:
                            raise GraphError(f"unknown via node '{via}'")
                        vnode = self._nodes[via].node
                        if not vnode.ALLOWS_FEEDBACK:
                            raise GraphError(
                                f"via node '{via}' "
                                f"({type(vnode).__name__}) does not "
                                f"allow feedback (AllowsFeedback)")
                        via_name = via
                    else:
                        via_name = f"__flat_via_{_via_ctr[0]}"
                        _via_ctr[0] += 1
                        from ..nodes.delay import Delay
                        f._nodes[via_name] = IrNodeInst(
                            via_name, Delay(float(int(via)), 0.0))
                    passthrough.append({
                        "src": stmt["src"],
                        "dst": EndpointRef(via_name, "input"),
                        "policy": stmt["policy"], "via": None,
                        "feedback": False})
                    stmt = {**stmt,
                            "src": EndpointRef(via_name, "output"),
                            "via": None, "feedback": True}
                outer_into.setdefault(
                    (dst.node, dst.endpoint), []).append(stmt)
            else:
                passthrough.append(stmt)

        _inlining: set = set()
        # per-emitted-stmt accumulator: feedback taint from via-backed
        # substitutions; outer array factors of inlined subgraphs
        _track = {"fb": False, "groups": set()}

        def subst_input(sub_name: str, in_name: str) -> Expr:
            stmts = outer_into.get((sub_name, in_name), [])
            if not stmts:
                gi = sub_input(sub_name, in_name)
                return Const(float(gi.default or 0.0))
            expr = None
            for s in stmts:
                if s.get("feedback"):
                    _track["fb"] = True
                e = rewrite(s["src"], None)
                expr = e if expr is None else BinOp("+", expr, e)
            return expr

        def rewrite(expr: Expr, ctx: Optional[str]) -> Expr:
            """Rewrite an expression; ``ctx`` names the subgraph whose
            internal namespace ``expr`` lives in (None = outer)."""
            if isinstance(expr, Const):
                return expr
            if isinstance(expr, BinOp):
                return BinOp(expr.op, rewrite(expr.lhs, ctx),
                             rewrite(expr.rhs, ctx))
            if isinstance(expr, Call):
                return Call(expr.fn, tuple(rewrite(a, ctx)
                                           for a in expr.args))
            if isinstance(expr, FrameCtor):
                return FrameCtor(tuple(rewrite(c, ctx)
                                       for c in expr.channels))
            assert isinstance(expr, EndpointRef)
            ref = expr
            if ctx is not None:
                if ref.node == "":
                    # inner graph-input reference -> outer substitution
                    base = subst_input(ctx, ref.endpoint)
                    return _apply_index_channel(base, ref.index,
                                                ref.channel)
                if ref.index is not None and subs[ctx].count > 1 \
                        and sub_flat[ctx]._nodes[ref.node].count > 1:
                    raise GraphError(
                        f"indexed reference '{ref.node}[{ref.index}]' "
                        f"inside array subgraph '{ctx}' is unsupported")
                return EndpointRef(f"{ctx}.{ref.node}", ref.endpoint,
                                   ref.index, ref.channel)
            if ref.node in subs:
                # outer read of a subgraph output -> inline its expr
                key = (ref.node, ref.endpoint)
                if key in _inlining:
                    raise GraphError(
                        f"cyclic subgraph output reference through "
                        f"{ref.node}.{ref.endpoint}")
                if subs[ref.node].count > 1:
                    _track["groups"].add(subs[ref.node].count)
                _inlining.add(key)
                try:
                    e = rewrite(sub_output_expr(ref.node, ref.endpoint),
                                ref.node)
                finally:
                    _inlining.discard(key)
                return _apply_index_channel(e, ref.index, ref.channel)
            return ref

        def _apply_index_channel(e: Expr, index, channel) -> Expr:
            if index is None and channel is None:
                return e
            if isinstance(e, EndpointRef):
                return EndpointRef(
                    e.node, e.endpoint,
                    index if e.index is None else e.index,
                    channel if e.channel is None else e.channel)
            raise GraphError(
                "cannot index/channel-extract a compound subgraph "
                "output expression")

        def input_kind(sub_name: str, in_name: str) -> Kind:
            return sub_input(sub_name, in_name).kind

        def _align_groups(expr: Expr, group: int) -> Expr:
            """Inside an array subgraph an expression mixing arrays of
            different per-instance multiplicities broadcasts naturally
            ([m] + [] per instance); flattened to one axis the counts
            (g*m1, g*m2) no longer broadcast.  Repeat lower-multiplicity
            refs up to the expression's max so each outer instance's
            lanes line up (same numeric result as the unnested
            broadcast)."""
            counts = {}
            for r in expr.endpoints():
                if r.node and r.index is None and r.node in f._nodes:
                    c = f._nodes[r.node].count
                    if c > 1:
                        counts[r.node] = c
            if len(set(counts.values())) <= 1:
                return expr
            M = max(counts.values())

            def walk(e: Expr) -> Expr:
                if isinstance(e, EndpointRef):
                    c = counts.get(e.node, 0)
                    if 1 < c < M:
                        if M % c:
                            raise GraphError(
                                f"array counts {c} and {M} inside an "
                                f"array subgraph (x{group}) are not "
                                f"per-instance compatible")
                        k = M // c
                        return Call(
                            functools.partial(_repeat_instances, k), (e,))
                    return e
                if isinstance(e, BinOp):
                    return BinOp(e.op, walk(e.lhs), walk(e.rhs))
                if isinstance(e, Call):
                    return Call(e.fn, tuple(walk(a) for a in e.args))
                if isinstance(e, FrameCtor):
                    return FrameCtor(tuple(walk(c_) for c_ in e.channels))
                return e
            return walk(expr)

        def _emit(stmt: dict, src_expr, ctx: Optional[str],
                  base_group: int) -> None:
            """Rewrite ``src_expr`` and append the stmt, folding the
            per-stmt feedback taint (via-backed substitutions) and the
            outer array factor into the emitted connection."""
            _track["fb"] = bool(stmt.get("feedback", False))
            _track["groups"] = set()
            src = rewrite(src_expr, ctx)
            group = base_group
            for g in _track["groups"]:
                group = max(group, g)
            if group > 1:
                src = _align_groups(src, group)
            f._connections.append({**stmt, "src": src,
                                   "feedback": _track["fb"],
                                   "group": group})

        # emit outer passthrough stmts (sources rewritten; reading an
        # array subgraph's outputs makes the stmt group-aware so fan-in
        # becomes a per-outer-instance segment sum)
        for stmt in passthrough:
            _emit(stmt, stmt["src"], None, stmt.get("group", 1))

        # emit inner stmts (prefixed; graph inputs substituted)
        for sub_name in subs:
            sub = sub_flat[sub_name]
            g_outer = self._nodes[sub_name].count
            for istmt in sub._connections:
                dst = istmt["dst"]
                if isinstance(dst, tuple):
                    continue  # inner graph-output assignment: inlined
                if dst.index is not None and g_outer > 1 \
                        and sub._nodes[dst.node].count > 1:
                    raise GraphError(
                        f"indexed destination '{dst.node}[{dst.index}]' "
                        f"inside array subgraph '{sub_name}' is "
                        f"unsupported")
                new_dst = EndpointRef(f"{sub_name}.{dst.node}",
                                      dst.endpoint, dst.index, dst.channel)
                src = istmt["src"]
                via = istmt.get("via")
                if isinstance(via, str):
                    via = f"{sub_name}.{via}"
                group = g_outer * istmt.get("group", 1)
                if isinstance(src, EndpointRef) and src.node == "" \
                        and input_kind(sub_name, src.endpoint) == Kind.EVENT:
                    # event routing: one edge per outer event source
                    for ostmt in outer_into.get(
                            (sub_name, src.endpoint), []):
                        _emit({"dst": new_dst, "policy": ostmt["policy"],
                               "via": None,
                               "feedback": istmt.get("feedback", False)},
                              ostmt["src"], None, group)
                else:
                    _emit({"dst": new_dst, "policy": istmt["policy"],
                           "via": via,
                           "feedback": istmt.get("feedback", False)},
                          src, sub_name, group)
        return f

    def get_input_decl(self, name: str) -> GraphInput:
        for i in self._inputs:
            if i.name == name:
                return i
        raise GraphError(f"{self.name} has no input '{name}'")

    # ------------------------------------------------------------------ #
    # lowering
    # ------------------------------------------------------------------ #
    def check(self) -> List[str]:
        """Validate without raising: returns every diagnostic found (the
        reference's accumulated Diagnostics, diagnostics.rs:40-107)."""
        try:
            self.lower(collect=True)
            return []
        except GraphError as e:
            return str(e).split("\n")

    def lower(self, collect: bool = False) -> IrGraph:
        flat = self._flatten()
        if flat is not self:
            return flat.lower(collect=collect)
        ir = IrGraph(self.name)
        ir.inputs = list(self._inputs)
        ir.outputs = list(self._outputs)
        ir.nodes = dict(self._nodes)
        # a top-level asset-kind graph input is its own publish handle:
        # ("__input__", n) bindings become an external named n
        ir.asset_bindings = [
            (b[0][1] if isinstance(b[0], tuple) else b[0], b[1], b[2])
            for b in self._asset_bindings]
        ir.inputs = [i for i in ir.inputs if i.kind != Kind.ASSET]

        # Lowering must be idempotent: check() then compile(), or two
        # compiles of the same builder, each get a fresh via-usage set and
        # deterministic synthesized-node names.
        self._via_used = set()
        self._synth_counter = 0

        diags: List[str] = []

        def step(fn, *args):
            """Run a lowering step; in collect mode accumulate the error
            and continue (multi-error recovery, reference parse.rs
            chunking + diagnostics.rs accumulation)."""
            try:
                fn(*args)
            except GraphError as e:
                if not collect:
                    raise
                diags.append(str(e))

        # -- step 3: build edges (via expansion, lower.rs:340-655) --------
        for stmt in self._connections:
            step(self._lower_stmt, ir, stmt)

        step(self._synthesize_output_taps, ir)
        step(self._classify_rates, ir)
        step(self._infer_fanout, ir)
        step(self._validate_kinds, ir)
        step(self._toposort, ir)
        step(self._dead_nodes, ir)
        if diags:
            # one combined report (the compile_error! collapse)
            raise GraphError("\n".join(dict.fromkeys(diags)))
        return ir

    # ................................................................. #
    def _synthesize_output_taps(self, ir: IrGraph) -> None:
        """A graph output fed from an oversampled node gets a synthesized
        base-rate tap node so the inner->outer edge carries the Down
        resampler (the reference allows `[sinc] clip.output -> audio_out`
        directly; the tap reproduces that with explicit edges)."""
        from ..nodes.basic import Gain

        for name in list(ir.output_edges):
            expr = ir.output_edges[name]
            inner = [r for r in expr.endpoints()
                     if r.node and r.node in ir.nodes
                     and ir.nodes[r.node].rate != 1]
            if not inner:
                continue
            tap_name = f"__output_tap_{name}"
            ir.nodes[tap_name] = IrNodeInst(tap_name, Gain(1.0))
            ir.edges.append(IrEdge(
                expr, tap_name, "input", None,
                ir.output_policies.get(name, Policy.DEFAULT)))
            ir.output_edges[name] = EndpointRef(tap_name, "output")

    # ................................................................. #
    def _lower_stmt(self, ir: IrGraph, stmt: dict) -> None:
        src, dst, policy, via = (stmt["src"], stmt["dst"], stmt["policy"],
                                 stmt["via"])
        if isinstance(dst, tuple) and dst[0] == "__output__":
            out_name = dst[1]
            if via is not None:
                raise GraphError("delay vias into graph outputs unsupported")
            if out_name in ir.output_edges:
                # stream fan-in at the graph output: sum
                ir.output_edges[out_name] = BinOp(
                    "+", ir.output_edges[out_name], src)
            else:
                ir.output_edges[out_name] = src
            if policy != Policy.DEFAULT:
                ir.output_policies[out_name] = policy
            return

        if stmt.get("feedback"):
            # explicit feedback edge: validate a feedback-capable node sits
            # on the cycle (the destination or one of the sources)
            candidates = [dst.node] + [r.node for r in src.endpoints()
                                       if r.node]
            if not any(ir.nodes[n].node.ALLOWS_FEEDBACK
                       for n in candidates if n in ir.nodes):
                raise GraphError(
                    "feedback edge requires a feedback-capable node "
                    "(AllowsFeedback) at its destination or source")
            ir.edges.append(IrEdge(src, dst.node, dst.endpoint, dst.index,
                                   policy, is_feedback=True,
                                   group=stmt.get("group", 1)))
            return

        if via is None:
            ir.edges.append(IrEdge(src, dst.node, dst.endpoint, dst.index,
                                   policy, group=stmt.get("group", 1)))
            return

        # -- delay via (lower.rs:509-655) ---------------------------------
        if isinstance(via, NodeRef):
            via = via.name
        if isinstance(via, str):
            if via not in ir.nodes:
                raise GraphError(f"unknown via node '{via}'")
            via_name = via
            if via_name in self._via_used:
                raise GraphError(
                    f"via node '{via_name}' used by more than one connection")
            self._via_used.add(via_name)
            vnode = ir.nodes[via_name].node
            if not vnode.ALLOWS_FEEDBACK:
                raise GraphError(
                    f"via node '{via_name}' ({type(vnode).__name__}) does "
                    f"not allow feedback (AllowsFeedback)")
        else:
            # samples via: synthesize Delay(N, 0.0)
            n = int(via)
            via_name = f"__inline_delay_{self._synth_counter}"
            self._synth_counter += 1
            from ..nodes.delay import Delay
            ir.nodes[via_name] = IrNodeInst(via_name, Delay(float(n), 0.0))
        # Edge 1: src -> via.input (non-feedback)
        ir.edges.append(IrEdge(src, via_name, "input", None, policy,
                               group=stmt.get("group", 1)))
        # Edge 2: via.output -> dst (feedback)
        ir.edges.append(IrEdge(EndpointRef(via_name, "output"),
                               dst.node, dst.endpoint, dst.index, policy,
                               is_feedback=True,
                               group=stmt.get("group", 1)))

    # ................................................................. #
    def _endpoint_kind(self, ir: IrGraph, ref: EndpointRef,
                       as_source: bool) -> Kind:
        if ref.node == "":
            return ir.get_input(ref.endpoint).kind
        n = ir.nodes[ref.node].node
        if as_source and n.has_output(ref.endpoint):
            return n.output(ref.endpoint).kind
        if not as_source and n.has_input(ref.endpoint):
            return n.input(ref.endpoint).kind
        if as_source:
            raise GraphError(f"'{ref.node}.{ref.endpoint}' is not an output")
        raise GraphError(f"'{ref.node}.{ref.endpoint}' is not an input")

    def _expr_kind(self, ir: IrGraph, e: Expr) -> Kind:
        """Kind of a source expression: events only appear bare; compound
        expressions are stream/value-typed."""
        if isinstance(e, EndpointRef):
            return self._endpoint_kind(ir, e, as_source=True)
        eps = e.endpoints()
        for ref in eps:
            k = self._endpoint_kind(ir, ref, as_source=True)
            if k == Kind.EVENT:
                raise GraphError("event endpoints cannot appear inside "
                                 "connection expressions")
        if not eps:
            return Kind.VALUE
        kinds = {self._endpoint_kind(ir, r, True) for r in eps}
        return Kind.STREAM if Kind.STREAM in kinds else Kind.VALUE

    def _validate_kinds(self, ir: IrGraph) -> None:
        """(S,S), (V,V), (V,S), (E,E) only (lower.rs:1099-1165)."""
        ok = {(Kind.STREAM, Kind.STREAM), (Kind.VALUE, Kind.VALUE),
              (Kind.VALUE, Kind.STREAM), (Kind.EVENT, Kind.EVENT),
              (Kind.STREAM, Kind.VALUE)}
        # (S,V) is rejected by the reference for *cross-rate* edges but a
        # same-rate stream->value assignment appears in practice via value
        # pass-throughs; the reference's kind inference unifies them.  We
        # accept S->V at same rate (it is a per-sample copy either way).
        diags: List[str] = []
        for e in ir.edges:
            try:
                sk = self._expr_kind(ir, e.source)
                dk = self._endpoint_kind(
                    ir, EndpointRef(e.dst_node, e.dst_endpoint),
                    as_source=False)
                if (sk, dk) not in ok:
                    diags.append(
                        f"cannot connect {sk.value} source to {dk.value} "
                        f"input ({e.dst_node}.{e.dst_endpoint})")
                elif dk == Kind.EVENT and e.fanout in (
                        Fanout.REPEAT, Fanout.SEGMENT_SUM):
                    diags.append(
                        f"event edges between differently-sized arrays "
                        f"inside an array subgraph are unsupported "
                        f"({e.dst_node}.{e.dst_endpoint})")
                else:
                    e.kind = dk
            except GraphError as err:
                diags.append(str(err))
        for name, expr in ir.output_edges.items():
            out = next(o for o in ir.outputs if o.name == name)
            try:
                sk = self._expr_kind(ir, expr)
                if out.kind == Kind.EVENT and sk != Kind.EVENT:
                    diags.append(f"output '{name}' expects events")
            except GraphError as err:
                diags.append(str(err))
        if diags:
            raise GraphError("\n".join(diags))

    # ................................................................. #
    def _classify_rates(self, ir: IrGraph) -> None:
        """Rate analysis (lower.rs:741-906): (Same, Up(n)) → Up kernel,
        (Up(n), Same) → Down, equal → None, mixed inner rates rejected."""
        def node_rate(ref: EndpointRef) -> int:
            return 1 if ref.node == "" else ir.nodes[ref.node].rate

        for e in ir.edges:
            src_eps = e.source.endpoints()
            src_rates = {node_rate(r) for r in src_eps} or {1}
            if len(src_rates) > 1:
                raise GraphError(
                    "connection expression mixes nodes at different rates")
            sr_ = src_rates.pop()
            dr_ = ir.nodes[e.dst_node].rate
            is_event = self._endpoint_kind(
                ir, EndpointRef(e.dst_node, e.dst_endpoint),
                as_source=False) == Kind.EVENT
            if sr_ == dr_:
                e.kernel = EdgeKernel.NONE
                e.rate_factor = 1
            elif is_event:
                # event edges cross rates via frame-offset rescale only
                # (reference EdgeKernel::Event{Multiply/Divide},
                # lower.rs:824-917); applied at staging from node rates
                e.kernel = (EdgeKernel.EVENT_MULTIPLY if dr_ > sr_
                            else EdgeKernel.EVENT_DIVIDE)
                e.rate_factor = max(sr_, dr_) // min(sr_, dr_)
            elif sr_ == 1 and dr_ > 1:
                e.kernel = EdgeKernel.UP
                e.rate_factor = dr_
            elif sr_ > 1 and dr_ == 1:
                e.kernel = EdgeKernel.DOWN
                e.rate_factor = sr_
            else:
                raise GraphError(
                    f"unsupported rate combination {sr_}x -> {dr_}x "
                    f"(only 1x↔Nx supported, as in the reference)")
        for name, expr in ir.output_edges.items():
            for r in expr.endpoints():
                if r.node and ir.nodes[r.node].rate != 1:
                    raise GraphError(
                        f"graph output '{name}' must be fed from the base "
                        f"rate; add an explicit downsampled edge")

    # ................................................................. #
    def _infer_fanout(self, ir: IrGraph) -> None:
        """Fanout shapes (ir/graph.rs:48-78) with min-truncation.

        Edges flattened out of array subgraphs carry ``group`` (the
        outer array factor g); per-outer-instance broadcast/fan-in
        between counts ``g`` and ``g*m`` lowers to REPEAT/SEGMENT_SUM
        on the flattened instance axis."""
        for e in ir.edges:
            src_count = 1
            for r in e.source.endpoints():
                if r.node and r.index is None:
                    src_count = max(src_count, ir.nodes[r.node].count)
            dst_count = (1 if e.dst_index is not None
                         else ir.nodes[e.dst_node].count)
            if src_count == 1 and dst_count == 1:
                e.fanout = Fanout.SCALAR
            elif src_count == 1:
                e.fanout = Fanout.BROADCAST
            elif dst_count == 1:
                e.fanout = Fanout.FAN_IN
            elif src_count == dst_count:
                e.fanout = Fanout.PARALLEL
            elif e.group > 1 and src_count % e.group == 0 \
                    and dst_count % e.group == 0:
                s_i, d_i = src_count // e.group, dst_count // e.group
                if s_i == 1:
                    e.fanout = Fanout.REPEAT
                    e.factor = d_i
                elif d_i == 1:
                    e.fanout = Fanout.SEGMENT_SUM
                    e.factor = s_i
                else:
                    raise GraphError(
                        f"array counts {s_i} -> {d_i} inside an array "
                        f"subgraph (x{e.group}) must match or be scalar "
                        f"per instance ('{e.dst_node}.{e.dst_endpoint}')")
            else:
                e.fanout = Fanout.PARALLEL

    # ................................................................. #
    def _toposort(self, ir: IrGraph) -> None:
        """Kahn toposort skipping feedback edges (lower.rs:1015-1085)."""
        names = list(ir.nodes.keys())
        incoming: Dict[str, set] = {n: set() for n in names}
        for e in ir.edges:
            if e.is_feedback:
                continue
            for r in e.source.endpoints():
                if r.node and r.node != e.dst_node:
                    incoming[e.dst_node].add(r.node)
        order: List[str] = []
        ready = sorted(n for n in names if not incoming[n])
        incoming_left = {n: set(v) for n, v in incoming.items()}
        while ready:
            n = ready.pop(0)
            order.append(n)
            for m in names:
                if n in incoming_left[m]:
                    incoming_left[m].discard(n)
                    if not incoming_left[m] and m not in order \
                            and m not in ready:
                        ready.append(m)
            ready.sort()
        if len(order) != len(names):
            cyclic = [n for n in names if n not in order]
            raise GraphError(
                f"graph contains a cycle through {cyclic}; break it with a "
                f"delay via (connect(..., via=N) or via a feedback-capable "
                f"node)")
        ir.order = order
        # mark feedback edges that actually read previous-sample values
        pos = {n: i for i, n in enumerate(order)}
        for e in ir.edges:
            if not e.is_feedback:
                continue
            src_nodes = [r.node for r in e.source.endpoints() if r.node]
            e.src_reads_state = any(
                pos[s] >= pos[e.dst_node] for s in src_nodes)

    # ................................................................. #
    def _dead_nodes(self, ir: IrGraph) -> None:
        """Reverse BFS from outputs (ir/passes/dead_nodes.rs:11-64).
        Skipped when the graph has no outputs."""
        if not ir.outputs:
            return
        # adjacency: dst -> source nodes (including feedback edges)
        live: set = set()
        frontier: List[str] = []
        for expr in ir.output_edges.values():
            for r in expr.endpoints():
                if r.node:
                    frontier.append(r.node)
        while frontier:
            n = frontier.pop()
            if n in live:
                continue
            live.add(n)
            for e in ir.edges:
                if e.dst_node == n:
                    for r in e.source.endpoints():
                        if r.node and r.node not in live:
                            frontier.append(r.node)
        dead = [n for n in ir.order if n not in live]
        for n in dead:
            del ir.nodes[n]
        ir.order = [n for n in ir.order if n in live]
        ir.edges = [e for e in ir.edges if e.dst_node in live]
        ir.asset_bindings = [b for b in ir.asset_bindings
                             if b[1] in live]

    # ------------------------------------------------------------------ #
    def compile(self, sample_rate: float = 44100.0, block_size: int = 512,
                mode: str = "block", jit: bool = True, device="cuda"):
        """Compile to a :class:`CompiledGraph` whose state and blocks live
        on ``device``: the CUDA card by default (without a card this
        raises), or ``"cpu"`` when asked for.  ``mode="block"`` (the
        default here, as in the JAX package) runs time-vectorized blocks;
        ``mode="sample"`` runs the reference's per-sample schedule, one
        step per sample (``CompiledGraph``'s own default).  ``jit=True``
        (the default, as in the JAX package) replays each block whose key
        has warmed up, in either mode, and every block of ``render_steady``
        and ``steady_checksum``, from a captured CUDA graph (a sample-mode
        block's B steps in one graph; on the CPU from the capture's static
        buffers, graph/capture.py); a sample-mode block that carries events
        stays eager; a voice-sharded block replays on an NCCL group and
        stays eager on a card's gloo group; ``jit=False`` runs every block
        eagerly."""
        from .compile import CompiledGraph
        ir = self.lower()
        return CompiledGraph(ir, sample_rate=sample_rate,
                             block_size=block_size, mode=mode, jit=jit,
                             device=device)

    def param_specs(self) -> Dict[str, ParamSpec]:
        """The ``nih_params`` equivalent: export value-input specs."""
        return {i.name: (i.spec or ParamSpec())
                for i in self._inputs if i.kind == Kind.VALUE}
