"""Block-mode execution: time-vectorized per-node blocks.

Counterpart of ``oscen_tpu/graph/block_mode.py``.  Each device node
processes the whole ``[B]`` block at once through its ``process_block``
(closed forms), in dependency order.  Value convention inside a block:
scalar nodes see time-leading ``[B, ...]`` tensors; node arrays see
instance-leading ``[C, B, ...]`` tensors and run as ONE call with the
instance axis written out (``Node.BATCHED``), or through their
``process_block_batched`` kernel path when the block has no events.

A node at ``rate=N`` processes ``B*N`` samples; a cross-rate edge runs its
resampler on the whole block, with the carried state in
``state["__rs__"]``.  A feedback edge reads its source one sample late: the
block shifted by one along time, seeded from ``state["__fb__"]``.  A
feedback island (a strongly connected component) dissolves when every
cycle passes through a ``Delay`` whose static ``min_delay >= B + 4``: the
delays read their whole block first, the rest of the island runs as
ordinary block nodes, and the delays write last.  Any other island runs as
a **per-sample scan island**: its external inputs are evaluated as whole
blocks first, then its nodes tick once per sample in topological order
(events at their host-known offsets, ``__fb__`` carries for the feedback
reads), and their outputs are stacked back into blocks.  An island inside
an oversampled region scans at the inner rate; one that spans a rate
boundary is refused, as in the JAX package.  A node array without an
instance-batched block path (a ``Delay`` array) runs its ticks over the
instance axis (the JAX package ``vmap``s there).

Stream-epilogue fusion (``OSCEN_EPILOGUE_FUSION=1``, read when the block
function is built; default off, as in the JAX package): a fused voice
mix-down whose single consumer is a scalar node with ``kernel_epilogue``
(the Tremolo) runs that node inside the producer's kernel, in every block
whose consumer value inputs are block-constant; the consumer then does not
run on its own.

Voice sharding (``shard=(group, n)``, switched on by
``parallel.voices.shard_compiled_state``): each of ``n`` processes runs the
block on its slice of every node array's instances, and every sum over the
instance axis (a fan-in mix-down, fused into the producer's kernel or not,
inside a scan island once per sample, a graph output's reduction) finishes
with an all-reduce over ``group``, the counterpart of the JAX package's
``psum`` under ``shard_map``.

Besides its inputs, a node's block methods may ask, by naming the keyword
in their signature, for what the compiler knows of them on the host:

- ``const_ins``: input endpoints that are block-constant THIS block
  (staged as ``[1]``, literals, or outputs that an upstream stateless node
  proved constant through its ``const_out_eps``);
- ``literal_ins``: ``{endpoint: float}`` of inputs whose value is a
  literal of the compiled graph: unconnected defaults, ``Const`` and
  ``+ - * /`` of them, and graph parameters never set since compile
  (``CompiledGraph._literal_params``; the first setter rebuilds the block
  function without them);
- ``folded_ins``: the part of ``literal_ins`` that holds no graph
  parameter: the values XLA folds at compile time in the JAX package,
  where a never-set parameter stays a runtime operand (a node's ``tick``
  may name it too: sample mode and scan islands pass it);
- ``host_ins``: ``{endpoint: float}`` of value inputs that are
  block-constant this block and whose value the host knows: literals and
  live graph parameters staged as ``[1]`` (the port's counterpart of the
  JAX package's ``CompiledGraph._host_input_value``; it replaces a device
  predicate, so no block ever reads the card);
- ``host_mirror``: ``{leaf: int}``, the host's copy of the state leaves
  the node names in ``HOST_MIRROR`` (the Convolver's ``fade_pos``), kept
  by ``CompiledGraph`` through the node's ``mirror_step`` after every
  publish and block; it too replaces a device predicate.
"""

from __future__ import annotations

import inspect
import os
from typing import Any, Dict, List, Tuple

import torch

from ..core.events import EventBuffer
from ..core.types import Kind
from . import explain
from .ir import (BinOp, Call, Const, EdgeKernel, EndpointRef, Fanout,
                 FrameCtor, IrEdge)
from .node import Node, apply_node_events, scan_tick_block, tree_map

__all__ = ["make_block_fn", "reconstruct_step_values", "fold_inputs",
           "tick_kwargs"]


def reconstruct_step_values(per_block: Dict[str, Any],
                            B: int) -> Dict[str, Any]:
    """Expand ``__hstep__<node>.<ep>`` step-staging tensors into the
    ``__host__<node>.<ep>`` per-sample tensors the block body consumes: a
    ``(3[, C])`` base/target/offset tensor becomes ``[B(, C)]`` with one
    select on the device (graph/node.py StepValue)."""
    if not any(k.startswith("__hstep__") for k in per_block):
        return per_block
    out = {}
    for k, v in per_block.items():
        if not k.startswith("__hstep__"):
            out[k] = v
            continue
        t = torch.arange(B, dtype=torch.float32, device=v.device)
        base, tgt, off = v[0], v[1], v[2]
        if v.dim() == 2:   # (3, C) -> [B, C]
            vals = torch.where(t[:, None] >= off[None, :],
                               tgt[None, :], base[None, :])
        else:              # (3,)  -> [B]
            vals = torch.where(t >= off, tgt, base)
        out["__host__" + k[len("__hstep__"):]] = vals
    return out


def _sccs(nodes: List[str], deps: Dict[str, set]) -> List[List[str]]:
    """Tarjan SCCs (iterative); components come out dependencies first."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Dict[str, bool] = {}
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str):
        work = [(v, iter(sorted(deps.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack[v] = True
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack[w] = True
                    work.append((w, iter(sorted(deps.get(w, ())))))
                    advanced = True
                    break
                elif on_stack.get(w):
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == node:
                        break
                out.append(comp)

    for v in nodes:
        if v not in index:
            strongconnect(v)
    return out


def _add_instance_axis(st, ins, evs):
    """A ``BATCHED`` node used as a scalar node runs as one instance."""
    return (tree_map(lambda x: x[None], st),
            {k: v[None] for k, v in ins.items()},
            {k: EventBuffer(b.offsets[None], b.values[None], b.valid[None])
             for k, b in evs.items()})


def _fold_expr(ex, leaf):
    """The float an edge expression holds on the host, or None: ``Const``,
    ``+ - * /`` over such values, and ``EndpointRef`` leaves as ``leaf``
    resolves them (the rules of the JAX package's ``literal_eps`` and
    ``_host_input_value``)."""
    if isinstance(ex, Const):
        return float(ex.value)
    if isinstance(ex, EndpointRef):
        return leaf(ex)
    if isinstance(ex, BinOp):
        lhs, rhs = _fold_expr(ex.lhs, leaf), _fold_expr(ex.rhs, leaf)
        if lhs is None or rhs is None or ex.op not in "+-*/":
            return None
        if ex.op == "/" and rhs == 0.0:
            return None    # not a host value: leave it to the device
        return {"+": lhs + rhs, "-": lhs - rhs, "*": lhs * rhs,
                "/": lhs / rhs}[ex.op]
    return None


def _signature_kw(fn, names) -> frozenset:
    return frozenset(names) & set(inspect.signature(fn).parameters)


def fold_inputs(prog, name: str, leaf) -> Dict[str, float]:
    """Value and stream endpoints of ``name`` whose every feeding edge folds
    to a host value (summed over fan-in edges); an unconnected endpoint
    holds its default.  ``leaf`` resolves an endpoint reference to a host
    value or None."""
    out = {}
    for ep in prog.ir.nodes[name].node.INPUTS:
        if ep.kind not in (Kind.VALUE, Kind.STREAM):
            continue
        edges = prog.edges_by_dst.get((name, ep.name), [])
        if not edges:
            out[ep.name] = float(ep.default or 0.0)
            continue
        total = None
        for e in edges:
            v = None
            if e.kernel == EdgeKernel.NONE and not e.is_feedback \
                    and e.dst_index is None:
                v = _fold_expr(e.source, leaf)
            if v is None:
                break
            total = v if total is None else total + v
        else:
            out[ep.name] = total
    return out


def tick_kwargs(prog) -> Dict[str, Dict[str, Any]]:
    """The keyword arguments each device node's ``tick`` names: its
    ``folded_ins`` (the literals XLA folds into the JAX package's compiled
    ticks)."""
    return {name: {"folded_ins": fold_inputs(prog, name, lambda ref: None)}
            for name in prog.device_nodes
            if "folded_ins" in _signature_kw(prog.ir.nodes[name].node.tick,
                                             ("folded_ins",))}


def make_block_fn(prog, block_len: int, literal_params=None,
                  host_params=None, host_mirrors=None, shard=None):
    """Build ``(state, per_block, ev_bufs) -> (state, out_blocks)``.

    ``literal_params``: values of the graph value inputs never set since
    compile (``literal_ins``); ``host_params``: a callable returning the
    current host values of the graph value inputs (``host_ins``);
    ``host_mirrors``: a callable returning ``{node: host mirror}``, read at
    every call (``host_mirror``).  ``shard=(group, n)`` builds one rank's
    body of a voice-sharded block (the JAX package's ``shard=(axis,
    n_shards)`` under ``shard_map``): every node array runs on its local
    instances (``count // n``; a count ``n`` does not divide raises
    ``ValueError``), its state and per-voice inputs arrive as this rank's
    slices, and every sum over the instance axis finishes with an
    all-reduce over ``group``.  Raises ``NotImplementedError`` for a
    feedback island that spans a rate boundary (the reference restricts
    cross-rate feedback too)."""
    from ..nodes.delay import Delay

    ir = prog.ir
    B = block_len
    literal_params = literal_params or {}
    group, n_shards = shard if shard is not None else (None, 1)

    def eff(count: int) -> int:
        """The local (this rank's) instance count of a node array."""
        if shard is not None and count > 1:
            if count % n_shards:
                raise ValueError(
                    f"voice count {count} not divisible by the "
                    f"{n_shards}-process mesh")
            return count // n_shards
        return count

    for name in prog.device_nodes:
        eff(ir.nodes[name].count)   # a count the mesh cannot split

    def all_reduce(v):
        """``v`` (a fresh tensor) summed over the mesh."""
        if shard is not None:
            import torch.distributed as dist
            dist.all_reduce(v, group=group)
        return v

    def from_arrays(ex) -> bool:
        return any(ir.nodes[r.node].count > 1 for r in ex.endpoints()
                   if r.node in ir.nodes)

    # dependency graph over device nodes (normal and feedback edges)
    deps: Dict[str, set] = {n: set() for n in prog.device_nodes}
    for e in ir.edges:
        if e.dst_node not in deps:
            continue
        for r in e.source.endpoints():
            if r.node and r.node in deps and r.node != e.dst_node:
                deps[e.dst_node].add(r.node)
    # components come out dependencies first; inside one, topo order
    topo_pos = {n: i for i, n in enumerate(ir.order)}
    comps = [sorted(c, key=topo_pos.get)
             for c in _sccs(prog.device_nodes, deps)]

    def is_island(comp: List[str]) -> bool:
        if len(comp) > 1:
            return True
        n = comp[0]
        return n in deps[n] or any(
            e.is_feedback and e.src_reads_state and e.dst_node == n
            and all(r.node == n for r in e.source.endpoints() if r.node)
            for e in ir.edges)

    def dissolve_plan(comp: List[str]):
        """(delays, the rest in evaluation order) of a feedback island
        whose every cycle passes through a single-instance Delay promising
        ``min_delay >= B + 4`` (the JAX package's dissolution rule), every
        read of which this block addresses pre-block contents; None when
        the island does not dissolve (it runs as a scan island)."""
        if any(ir.nodes[n].rate != 1 for n in comp):
            return None
        cset = set(comp)
        dels = [n for n in comp if isinstance(ir.nodes[n].node, Delay)
                and ir.nodes[n].node.min_delay >= B + 4
                and ir.nodes[n].count == 1]
        if not dels:
            return None
        for d in dels:
            for epn in ("delay_samples", "feedback"):
                for e in prog.edges_by_dst.get((d, epn), []):
                    if any(r.node in cset for r in e.source.endpoints()):
                        return None   # params fed from inside the island
        pending = {n: (deps[n] & cset) - set(dels)
                   for n in comp if n not in dels}
        order: List[str] = []
        while pending:
            ready = sorted((n for n, d_ in pending.items()
                            if not d_ & set(pending)), key=topo_pos.get)
            if not ready:
                return None   # a cycle not broken by the delays
            order.extend(ready)
            for n in ready:
                del pending[n]
        return dels, order

    islands = [c for c in comps if is_island(c)]
    plans = {id(c): dissolve_plan(c) for c in islands}
    for c in islands:
        if plans[id(c)] is None and len({ir.nodes[n].rate for n in c}) > 1:
            raise NotImplementedError(
                f"feedback island {sorted(c)} spans a rate boundary: "
                f"unsupported (the reference similarly restricts cross-rate "
                f"feedback)")
    island_nodes = {n for c in islands for n in c}

    # FanIn fusion: node-array outputs whose ONLY consumers are bare
    # full-instance fan-in sums (and which feed no island, feedback carry
    # or graph output expression) may be pre-reduced inside the producing
    # node's batched kernel: ``process_block_batched(..., fanin_eps)`` then
    # returns ``__fanin__<ep>`` for them.
    consumers: Dict[Tuple[str, str], List[IrEdge]] = {}
    for e in ir.edges:
        for r in e.source.endpoints():
            if r.node:
                consumers.setdefault((r.node, r.endpoint), []).append(e)
    out_refs = {(r.node, r.endpoint)
                for expr in ir.output_edges.values()
                for r in expr.endpoints() if r.node}
    fb_refs = set(prog.fb_keys)
    fanin_only: Dict[str, frozenset] = {}
    for name in prog.device_nodes:
        inst = ir.nodes[name]
        if inst.count <= 1:
            continue
        eps = set()
        for ep in inst.node.OUTPUTS:
            key = (name, ep.name)
            edges = consumers.get(key, [])
            if edges and key not in out_refs and key not in fb_refs \
                    and all(isinstance(e.source, EndpointRef)
                            and e.fanout == Fanout.FAN_IN
                            and e.dst_index is None
                            and e.kernel == EdgeKernel.NONE
                            and not e.is_feedback
                            and e.dst_node not in island_nodes
                            for e in edges):
                eps.add(ep.name)
        if eps:
            fanin_only[name] = frozenset(eps)
    # stream-epilogue fusion, static half (JAX block_mode.py:228-265): a
    # fused-mixdown output whose single consumer is a scalar, rate-1 node
    # with ``kernel_epilogue``, no event inputs, that edge as its only
    # stream input, and one output
    epi_static: Dict[str, Tuple[str, str]] = {}
    # off under sharding (its consumer must see the all-reduced mix)
    if os.environ.get("OSCEN_EPILOGUE_FUSION", "0") != "0" \
            and shard is None:
        for name, eps in fanin_only.items():
            for epn in eps:
                edges = consumers.get((name, epn), [])
                if len(edges) != 1:
                    continue
                t = edges[0].dst_node
                ti = ir.nodes.get(t)
                if ti is None or ti.count != 1 or ti.rate != 1 \
                        or ir.nodes[name].rate != 1 or t in island_nodes \
                        or not hasattr(ti.node, "kernel_epilogue") \
                        or len(ti.node.OUTPUTS) != 1:
                    continue
                if all(p.kind != Kind.EVENT and (
                        p.kind != Kind.STREAM
                        or prog.edges_by_dst.get((t, p.name), []) == (
                            [edges[0]] if p.name == edges[0].dst_endpoint
                            else []))
                       for p in ti.node.INPUTS):
                    epi_static[name] = (epn, t)
    # the keyword arguments each node's block methods take, read from
    # their signatures as the JAX package does (block_mode.py:642-687)
    host_kw = ("const_ins", "literal_ins", "folded_ins", "host_ins",
               "host_mirror")
    block_kw = {name: _signature_kw(ir.nodes[name].node.process_block,
                                    host_kw)
                for name in prog.device_nodes}
    batched_kw = {
        name: _signature_kw(ir.nodes[name].node.process_block_batched,
                            ("fanin_eps", "epilogue") + host_kw)
        for name in prog.device_nodes
        if hasattr(ir.nodes[name].node, "process_block_batched")}

    def literal_leaf(ref):
        # a never-set graph parameter holding its default is a literal
        if ref.node == "" and ref.endpoint in literal_params:
            return float(literal_params[ref.endpoint])
        return None

    # literals depend on the graph and literal_params alone
    literals = {name: fold_inputs(prog, name, literal_leaf)
                for name in prog.device_nodes}
    folded = {name: fold_inputs(prog, name, lambda ref: None)
              for name in prog.device_nodes}
    tick_kw = tick_kwargs(prog)

    def payload_shape(ep):
        return ep.shape if ep.shape else (
            () if ep.channels == 1 else (ep.channels,))

    def local_default(inst, ep):
        """A scan island's per-sample default, sized to the local count
        (the JAX package's ``_local_default``)."""
        shape = ((eff(inst.count),) if inst.count > 1 else ()) \
            + tuple(payload_shape(ep))
        return prog.const(float(ep.default or 0.0), shape)

    def normalize(v, count, n, payload, is_array):
        """Shape an edge value as the destination's block ((C,)?, n,
        *payload): payload dims align at the end, missing time/instance
        axes are prepended."""
        target = ((count,) if is_array else ()) + (n,) + payload
        v = torch.as_tensor(v)
        while v.dim() < len(target):
            tail = target[len(target) - v.dim():] if v.dim() else ()
            compatible = v.dim() > 0 and all(
                s == t_ or s == 1 for s, t_ in zip(v.shape, tail))
            v = v[None] if compatible else v[..., None]
        return torch.broadcast_to(v, target)

    def const_keys(shapes) -> frozenset:
        """The ``per_block`` keys staged as ``[1]`` (idle params,
        block-constant host values), from ``{key: shape}``: block-constant
        THIS block, so nodes may drop their per-sample parameter-change
        paths (const_eps).  A captured block's key reads the same rule
        (``host_key``)."""
        return frozenset(k for k, s in shapes.items()
                         if len(s) >= 1 and s[0] == 1 and B != 1)

    def block_fn(state, per_block, ev_bufs):
        per_block = reconstruct_step_values(per_block, B)
        const_inputs = const_keys({k: v.shape for k, v in per_block.items()})
        per_block = {
            k: (v.expand((B,) + tuple(v.shape[1:]))
                if k in const_inputs else v)
            for k, v in per_block.items()}
        env: Dict[Tuple[str, str], Any] = {}
        new_state = dict(state)
        new_state["__rs__"] = dict(state["__rs__"])
        fb = dict(state["__fb__"])
        # node outputs proven block-constant this block (filled in order by
        # stateless nodes' const_out_eps, e.g. a MulAdd with a literal 0.0
        # gain), so const-ness propagates through modulation chains
        const_outs: set = set()
        const_memo: Dict[str, frozenset] = {}
        params: List[Dict[str, float]] = []
        # consumers that ran inside their producer's kernel epilogue
        fused_away: set = set()

        def resolver(edge):
            """Endpoint values for ``edge`` (None: a graph output)."""
            def resolve(ref: EndpointRef):
                if ref.node == "":
                    return per_block[ref.endpoint]      # [B] or [B, C]
                if ref.node in prog.host_set:
                    v = per_block[f"__host__{ref.node}.{ref.endpoint}"]
                    if v.dim() == 2:  # [B, C] -> instance-leading [C, B]
                        v = v.transpose(0, 1)
                    return v
                v = env[(ref.node, ref.endpoint)]
                if edge is not None and edge.is_feedback \
                        and edge.src_reads_state:
                    # the previous sample: the block shifted by one along
                    # time, seeded with the carry of the last block
                    taxis = 1 if ir.nodes[ref.node].count > 1 else 0
                    init = state["__fb__"][f"{ref.node}.{ref.endpoint}"]
                    v = torch.cat([init.unsqueeze(taxis),
                                   v.narrow(taxis, 0, B - 1)], dim=taxis)
                return v
            return resolve

        def edge_value(e, inst, ep, indexed: bool):
            """Evaluate one edge for its destination (fan-in sum, parallel
            truncation, broadcast, cross-rate resampling with carried
            kernel state)."""
            pre = None
            if e.fanout == Fanout.FAN_IN and e.dst_index is None \
                    and isinstance(e.source, EndpointRef):
                pre = env.get((e.source.node,
                               "__fanin__" + e.source.endpoint))
            if pre is not None:
                # mix-down fused into the producer's kernel (a copy is
                # all-reduced: the kernel's output may feed other edges)
                v = all_reduce(pre.clone()) if shard is not None else pre
            else:
                v = prog.eval_expr(e.source, resolver(e))
                if e.dst_index is None:
                    if e.fanout == Fanout.FAN_IN:
                        v = torch.sum(v, dim=0)  # instance axis leads
                        if from_arrays(e.source):
                            v = all_reduce(v)
                    elif e.fanout == Fanout.REPEAT:
                        v = torch.repeat_interleave(v, e.factor, dim=0)
                    elif e.fanout == Fanout.SEGMENT_SUM:
                        v = prog.segment_sum(v, e.factor)
            is_array = not indexed and inst.count > 1
            count = 1 if indexed else eff(inst.count)
            n_src = B * (inst.rate if e.kernel == EdgeKernel.NONE else
                         1 if e.kernel == EdgeKernel.UP else e.rate_factor)
            if is_array and e.fanout == Fanout.PARALLEL and v.dim() >= 1 \
                    and v.shape[0] not in (count, n_src):
                v = v[:count]
            v = normalize(v, count, n_src, payload_shape(ep), is_array)
            if e.kernel in (EdgeKernel.UP, EdgeKernel.DOWN):
                idx = prog.edge_ids[id(e)]
                kern = prog.resamplers[idx]
                explain.note(edge=idx, input=ep.name,
                             resampler=type(kern).__name__,
                             factor=e.rate_factor)
                if is_array:
                    v = v.movedim(0, -1)    # [n, *payload, C]
                st, v = kern.process_block(new_state["__rs__"][str(idx)], v)
                new_state["__rs__"][str(idx)] = st
                if is_array:
                    v = v.movedim(-1, 0)
            return v

        def default_block(inst, ep):
            full = ((eff(inst.count),) if inst.count > 1 else ()) \
                + (B * inst.rate,) + payload_shape(ep)
            return torch.full(full, float(ep.default or 0.0),
                              dtype=torch.float32, device=prog.device)

        def gather_block(name: str, only_eps=None) -> Dict[str, Any]:
            inst = ir.nodes[name]
            ins: Dict[str, Any] = {}
            for ep in inst.node.INPUTS:
                if ep.kind in (Kind.EVENT, Kind.ASSET):
                    continue
                if only_eps is not None and ep.name not in only_eps:
                    continue
                val = None
                for e in prog.edges_by_dst.get((name, ep.name), []):
                    v = edge_value(e, inst, ep, e.dst_index is not None)
                    if e.dst_index is not None:
                        val = (val if val is not None
                               else default_block(inst, ep)).clone()
                        val[e.dst_index] = v
                    elif val is None:
                        val = v
                    else:
                        val = val + v
                ins[ep.name] = (val if val is not None
                                else default_block(inst, ep))
            return ins

        def const_eps(name: str) -> frozenset:
            """Input endpoints of ``name`` that are block-constant in THIS
            block: unconnected, or fed only by plain edges whose every
            endpoint leaf is staged as [1] or is a proven-constant node
            output (the rest literals or arithmetic on them)."""
            if name in const_memo:
                return const_memo[name]

            def expr_const(ex) -> bool:
                if isinstance(ex, Const):
                    return True
                if isinstance(ex, BinOp):
                    return expr_const(ex.lhs) and expr_const(ex.rhs)
                if isinstance(ex, Call):
                    return all(expr_const(a) for a in ex.args)
                if isinstance(ex, FrameCtor):
                    return all(expr_const(c) for c in ex.channels)
                if isinstance(ex, EndpointRef):
                    if ex.node == "":
                        return ex.endpoint in const_inputs
                    if ex.node in prog.host_set:
                        return (f"__host__{ex.node}.{ex.endpoint}"
                                in const_inputs)
                    return (ex.node, ex.endpoint) in const_outs
                return False

            out = set()
            for ep in ir.nodes[name].node.INPUTS:
                if ep.kind in (Kind.EVENT, Kind.ASSET):
                    continue
                if all(expr_const(e.source) and e.kernel == EdgeKernel.NONE
                       and not e.is_feedback
                       for e in prog.edges_by_dst.get((name, ep.name), [])):
                    out.add(ep.name)
            const_memo[name] = frozenset(out)
            return const_memo[name]

        def host_leaf(ref):
            # a live graph parameter staged as [1]: its host value
            if ref.node != "" or ref.endpoint not in const_inputs:
                return None
            if not params:
                params.append(host_params() if host_params else {})
            return params[0].get(ref.endpoint)

        def host_kwargs(name: str, wanted) -> Dict[str, Any]:
            kw: Dict[str, Any] = {}
            if "const_ins" in wanted:
                kw["const_ins"] = const_eps(name)
            if "literal_ins" in wanted:
                kw["literal_ins"] = literals[name]
            if "folded_ins" in wanted:
                kw["folded_ins"] = folded[name]
            if "host_ins" in wanted:
                value_eps = {ep.name for ep in ir.nodes[name].node.INPUTS
                             if ep.kind == Kind.VALUE}
                kw["host_ins"] = {k: v for k, v in
                                  fold_inputs(prog, name, host_leaf).items()
                                  if k in value_eps}
            if "host_mirror" in wanted:
                kw["host_mirror"] = (host_mirrors() if host_mirrors
                                     else {}).get(name)
            return kw

        def epilogue_for(name: str, Bn: int):
            """Dynamic half of the epilogue fusion (JAX block_mode.py:
            625-641): the consumer's value inputs are block-constant THIS
            block.  Returns ``(ep, C, fn, params, consumer, its new state,
            its output name)`` or None."""
            ep, t = epi_static[name]
            ti = ir.nodes[t]
            vals_eps = {p.name for p in ti.node.INPUTS
                        if p.kind == Kind.VALUE}
            if not vals_eps <= const_eps(t):
                return None
            vals = {k: v[0] for k, v in
                    gather_block(t, only_eps=vals_eps).items()}
            C, fn, prm, t_state = ti.node.kernel_epilogue(
                new_state[t], vals, prog.scaled_sr(ti), Bn)
            return (ep, C, fn, prm, t, t_state, ti.node.OUTPUTS[0].name)

        def run_node(name: str) -> None:
            inst = ir.nodes[name]
            node = inst.node
            sr = prog.scaled_sr(inst)
            Bn = B * inst.rate   # an oversampled node runs B*N samples
            ins = gather_block(name)
            evs = {ep.name: ev_bufs[f"{name}.{ep.name}"]
                   for ep in node.INPUTS if ep.kind == Kind.EVENT
                   and f"{name}.{ep.name}" in ev_bufs
                   and ev_bufs[f"{name}.{ep.name}"].capacity > 0}
            st = new_state[name]
            batched = None
            epi = None
            if inst.count > 1 and not evs and name in batched_kw:
                # voice-batched kernel path (None: take process_block)
                bkw = host_kwargs(name, batched_kw[name])
                if "fanin_eps" in batched_kw[name]:
                    bkw["fanin_eps"] = fanin_only.get(name, frozenset())
                if name in epi_static and "epilogue" in batched_kw[name]:
                    epi = epilogue_for(name, Bn)
                    if epi is not None:
                        bkw["epilogue"] = epi[:4]
                batched = node.process_block_batched(st, ins, evs, sr, Bn,
                                                     **bkw)
            if batched is not None:
                explain.note(path="batched")
                st, outs = batched
                if epi is not None and f"__epi__{epi[0]}" in outs:
                    ep, _, _, _, t, t_state, t_out = epi
                    env[(t, t_out)] = outs.pop(f"__epi__{ep}")
                    new_state[t] = t_state
                    fused_away.add(t)
                    explain.note(epilogue_fused_consumer=t)
            elif inst.count > 1:
                # the JAX package's name for this path (it vmaps there)
                explain.note(path="vmap")
                if node.BATCHED:
                    st, outs = node.process_block(
                        st, ins, evs, sr, Bn,
                        **host_kwargs(name, block_kw[name]))
                else:
                    # no instance-batched block path: the ticks, which
                    # broadcast over the instance axis
                    explain.note(tick_scan=True)
                    st, outs = scan_tick_block(node, st, ins, evs, sr, Bn,
                                               taxis=1)
            else:
                explain.note(path="block")
                kw = host_kwargs(name, block_kw[name])
                if node.BATCHED:
                    st1, ins1, evs1 = _add_instance_axis(st, ins, evs)
                    st, outs = node.process_block(st1, ins1, evs1, sr, Bn,
                                                  **kw)
                    st = tree_map(lambda x: x[0], st)
                    outs = {k: v[0] for k, v in outs.items()}
                else:
                    st, outs = node.process_block(st, ins, evs, sr, Bn, **kw)
            new_state[name] = st
            for k, v in outs.items():
                env[(name, k)] = v  # [C, Bn, ...] / [Bn, ...]
            # const-ness propagation: a stateless node may prove outputs
            # block-constant from its (const, literal) input sets
            cfn = getattr(node, "const_out_eps", None)
            if cfn is not None:
                ceps = cfn(const_eps(name), literals[name])
                if ceps:
                    const_outs.update((name, epn) for epn in ceps)
                    explain.note(const_outputs=sorted(ceps))

        def run(name: str) -> None:
            if name in fused_away:
                explain.note(node=name, path="fused_into_producer_epilogue")
                return   # ran inside its producer's kernel epilogue
            with explain.processing(name):
                run_node(name)

        def scan_island(island: List[str]) -> None:
            """A feedback island, sample by sample (JAX block_mode.py:
            729-922): external inputs as whole blocks sliced per sample,
            the nodes' ticks in topological order with their events, the
            feedback reads from the island's ``__fb__`` carries, and the
            outputs stacked back into blocks (``[C, Bn, ...]`` for
            arrays).  An oversampled island scans ``B*N`` inner samples:
            its external inputs come through their resamplers, its event
            offsets are scaled on the host, its carries advance one inner
            sample."""
            for n in island:
                explain.note(node=n, path="scan_island",
                             island=sorted(island))
            island_set = set(island)
            Bn = B * ir.nodes[island[0]].rate
            # inputs from outside the island, fully normalized, time-major
            ext: Dict[Tuple[str, str, int], Any] = {}
            for name in island:
                inst = ir.nodes[name]
                for ep in inst.node.INPUTS:
                    if ep.kind in (Kind.EVENT, Kind.ASSET):
                        continue
                    for j, e in enumerate(prog.edges_by_dst.get(
                            (name, ep.name), [])):
                        if {r.node for r in e.source.endpoints()
                                if r.node} & island_set:
                            continue   # internal edge
                        v = edge_value(e, inst, ep, e.dst_index is not None)
                        if inst.count > 1 and e.dst_index is None:
                            v = v.movedim(1, 0)
                        ext[(name, ep.name, j)] = v
            ist = {n: ir.nodes[n].node.own_state(new_state[n])
                   for n in island}
            fb_here = [f"{n}.{epn}" for (n, epn) in prog.fb_keys
                       if n in island_set]
            carries = {k: fb[k] for k in fb_here}
            outs_t: Dict[Tuple[str, str], list] = {}
            for t in range(Bn):
                env_t: Dict[Tuple[str, str], Any] = {}

                def resolve_t(edge):
                    def r(ref: EndpointRef):
                        if ref.node == "":
                            return per_block[ref.endpoint][t]
                        if ref.node in prog.host_set:
                            return per_block[
                                f"__host__{ref.node}.{ref.endpoint}"][t]
                        key = (ref.node, ref.endpoint)
                        if ref.node not in island_set and key in env:
                            return env[key].select(
                                1 if ir.nodes[ref.node].count > 1 else 0, t)
                        if key in env_t and not (
                                edge is not None and edge.is_feedback
                                and edge.src_reads_state):
                            return env_t[key]
                        return carries[f"{ref.node}.{ref.endpoint}"]
                    return r

                for name in island:
                    inst = ir.nodes[name]
                    node = inst.node
                    sr = prog.scaled_sr(inst)
                    ins = {}
                    for ep in node.INPUTS:
                        if ep.kind in (Kind.EVENT, Kind.ASSET):
                            continue
                        val = None
                        for j, e in enumerate(prog.edges_by_dst.get(
                                (name, ep.name), [])):
                            if (name, ep.name, j) in ext:
                                v = ext[(name, ep.name, j)][t]
                            else:
                                v = prog.eval_expr(e.source, resolve_t(e))
                                if e.dst_index is None:
                                    if e.fanout == Fanout.FAN_IN:
                                        v = torch.sum(v, dim=0)
                                        if from_arrays(e.source):
                                            v = all_reduce(v)
                                    elif e.fanout == Fanout.REPEAT:
                                        v = torch.repeat_interleave(
                                            v, e.factor, dim=0)
                                    elif e.fanout == Fanout.SEGMENT_SUM:
                                        v = prog.segment_sum(v, e.factor)
                                    if inst.count > 1 and e.fanout in (
                                            Fanout.SCALAR, Fanout.BROADCAST):
                                        v = prog._broadcast_to_count(
                                            v, eff(inst.count))
                            if e.dst_index is not None:
                                val = (val if val is not None else
                                       local_default(inst, ep)).clone()
                                val[e.dst_index] = v
                            elif val is None:
                                val = v
                            else:
                                val = val + v
                        ins[ep.name] = (val if val is not None
                                        else local_default(inst, ep))
                    st = apply_node_events(node, ist[name], name, ev_bufs, t,
                                           sr, ins)
                    ist[name], o = node.tick_owned(st, ins, sr,
                                                   **tick_kw.get(name, {}))
                    for k, v in o.items():
                        env_t[(name, k)] = v
                carries = {**carries, **{k: env_t[tuple(k.rsplit(".", 1))]
                                         for k in fb_here}}
                for key, v in env_t.items():
                    outs_t.setdefault(key, []).append(v)
            new_state.update(ist)
            fb.update(carries)
            for (n, k), vs in outs_t.items():
                env[(n, k)] = torch.stack(
                    vs, dim=1 if ir.nodes[n].count > 1 else 0)

        for comp in comps:
            if id(comp) not in plans:
                run(comp[0])
                continue
            plan = plans[id(comp)]
            if plan is None:
                scan_island(comp)
                continue
            # dissolved feedback island: read the delays, run the acyclic
            # rest, write the delays
            dels, rest = plan
            stash = {}
            for d in dels:
                explain.note(node=d, path="dissolved_island_delay")
                ins_p = gather_block(d, only_eps=("delay_samples",
                                                  "feedback"))
                delayed, fbc = ir.nodes[d].node.block_read(
                    new_state[d], ins_p, B, literal_ins=literals[d])
                env[(d, "output")] = delayed
                stash[d] = (delayed, fbc)
            for n in rest:
                run(n)
            for d in dels:
                x = gather_block(d, only_eps=("input",))["input"]
                new_state[d] = ir.nodes[d].node.block_write(
                    new_state[d], x, *stash[d], B)

        # refresh the feedback carries: the last sample of the block, at
        # the producing node's own rate
        for (n, epn) in prog.fb_keys:
            v = env.get((n, epn))
            if v is not None:
                taxis = 1 if ir.nodes[n].count > 1 else 0
                fb[f"{n}.{epn}"] = v.select(taxis, B * ir.nodes[n].rate - 1)
        new_state["__fb__"] = fb

        # graph outputs
        outs = {}
        for o in ir.outputs:
            if o.kind == Kind.EVENT:
                continue  # event outputs are routed host-side
            expr = ir.output_edges.get(o.name)
            if expr is None:
                shape = (B,) if o.channels == 1 else (B, o.channels)
                outs[o.name] = torch.zeros(shape, dtype=torch.float32,
                                           device=prog.device)
                continue
            v = prog.eval_expr(expr, resolver(None))
            want = 1 if o.channels == 1 else 2
            reduced = v.dim() > want
            while v.dim() > want:
                v = torch.sum(v, dim=0)
            if reduced and from_arrays(expr):
                v = all_reduce(v)   # the instance sum spans the mesh
            outs[o.name] = v
        return new_state, outs

    # what a call decides from the host besides its inputs' shapes, the key
    # of a captured block (graph/capture.py): the graph parameters that
    # feed a node's host_ins, the host mirrors, the additive version
    from ..ops.cuda.additive import kernel_version
    asks = {name: block_kw[name] | batched_kw.get(name, frozenset())
            for name in prog.device_nodes}
    host_in_params = tuple(sorted({
        r.endpoint for name in prog.device_nodes
        if "host_ins" in asks[name]
        for ep in ir.nodes[name].node.INPUTS
        for e in prog.edges_by_dst.get((name, ep.name), [])
        for r in e.source.endpoints() if r.node == ""}))
    mirror_nodes = tuple(name for name in prog.device_nodes
                         if "host_mirror" in asks[name])

    def host_key(shapes) -> tuple:
        """``shapes``: the staged ``per_block`` shapes by key; a parameter
        that is not block-constant (a ramp) is not read (``host_leaf``),
        so its value is not in the key."""
        p = host_params() if host_params and host_in_params else {}
        m = host_mirrors() if host_mirrors and mirror_nodes else {}
        const = const_keys(shapes)
        return (tuple(p.get(k) if k in const else None
                      for k in host_in_params),
                tuple(tuple(sorted((m.get(n) or {}).items()))
                      for n in mirror_nodes),
                kernel_version())

    # whether a call reads the event buffers' host slots: the per-sample
    # loops apply events at them (Node.apply_events_scheduled), a scan
    # island's ticks and a node whose block is its tick scan (no block
    # method of its own, or a node array without a batched one); every
    # other block method reads the offsets on the device.  A block given no
    # slots takes the masked form over every slot, equal bit for bit.
    def ticks_events(name: str) -> bool:
        inst = ir.nodes[name]
        node = inst.node
        return any(ep.kind == Kind.EVENT for ep in node.INPUTS) and (
            type(node).process_block is Node.process_block
            or (inst.count > 1 and not node.BATCHED))

    block_fn.host_key = host_key
    block_fn.reads_slots = (
        any(plans[id(c)] is None for c in islands)
        or any(ticks_events(n) for n in prog.device_nodes))
    return block_fn
