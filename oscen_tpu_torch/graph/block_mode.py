"""Block-mode execution: time-vectorized per-node blocks.

Counterpart of ``oscen_tpu/graph/block_mode.py``.  Each device node
processes the whole ``[B]`` block at once through its ``process_block``
(closed forms), in dependency order.  Value convention inside a block:
scalar nodes see time-leading ``[B, ...]`` tensors; node arrays see
instance-leading ``[C, B, ...]`` tensors and run as ONE call with the
instance axis written out (``Node.BATCHED``), or through their
``process_block_batched`` kernel path when the block has no events.

Not ported yet, and refused with ``NotImplementedError``: feedback cycles
(per-sample scan islands and dissolved delay islands), cross-rate edges,
voice sharding and the stream-epilogue fusion (ROADMAP.md queue 1).
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Tuple

import torch

from ..core.events import EventBuffer
from ..core.types import Kind
from . import explain
from .ir import (BinOp, Call, Const, EdgeKernel, EndpointRef, Fanout,
                 FrameCtor, IrEdge)
from .node import tree_map

__all__ = ["make_block_fn", "reconstruct_step_values"]


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


def make_block_fn(prog, block_len: int):
    """Build ``(state, per_block, ev_bufs) -> (state, out_blocks)``."""
    ir = prog.ir
    B = block_len

    # dependency graph over device nodes
    deps: Dict[str, set] = {n: set() for n in prog.device_nodes}
    for e in ir.edges:
        if e.dst_node not in deps:
            continue
        for r in e.source.endpoints():
            if r.node and r.node in deps and r.node != e.dst_node:
                deps[e.dst_node].add(r.node)
    comps = _sccs(prog.device_nodes, deps)
    for comp in comps:
        if len(comp) > 1 or comp[0] in deps[comp[0]]:
            raise NotImplementedError(
                f"feedback cycle through {sorted(comp)}: per-sample scan "
                f"islands are not ported yet (ROADMAP.md queue 1, item 4)")
    order = [c[0] for c in comps]

    # FanIn fusion: node-array outputs whose ONLY consumers are bare
    # full-instance fan-in sums (and which feed no graph output
    # expression) may be pre-reduced inside the producing node's batched
    # kernel: ``process_block_batched(..., fanin_eps)`` then returns
    # ``__fanin__<ep>`` for them.
    consumers: Dict[Tuple[str, str], List[IrEdge]] = {}
    for e in ir.edges:
        for r in e.source.endpoints():
            if r.node:
                consumers.setdefault((r.node, r.endpoint), []).append(e)
    out_refs = {(r.node, r.endpoint)
                for expr in ir.output_edges.values()
                for r in expr.endpoints() if r.node}
    fanin_only: Dict[str, frozenset] = {}
    for name in prog.device_nodes:
        inst = ir.nodes[name]
        if inst.count <= 1:
            continue
        eps = set()
        for ep in inst.node.OUTPUTS:
            key = (name, ep.name)
            edges = consumers.get(key, [])
            if edges and key not in out_refs \
                    and all(isinstance(e.source, EndpointRef)
                            and e.fanout == Fanout.FAN_IN
                            and e.dst_index is None
                            and e.kernel == EdgeKernel.NONE
                            for e in edges):
                eps.add(ep.name)
        if eps:
            fanin_only[name] = frozenset(eps)
    # nodes whose process_block specializes on block-constant inputs
    takes_const = {
        name for name in prog.device_nodes
        if "const_ins" in inspect.signature(
            ir.nodes[name].node.process_block).parameters}

    def block_fn(state, per_block, ev_bufs):
        per_block = reconstruct_step_values(per_block, B)
        # per_block entries staged as [1] (idle params, block-constant
        # host values) are block-constant THIS block: nodes may drop
        # their per-sample parameter-change paths (const_eps)
        const_inputs = {
            k for k, v in per_block.items()
            if v.dim() >= 1 and v.shape[0] == 1 and B != 1}
        per_block = {
            k: (v.expand((B,) + tuple(v.shape[1:]))
                if k in const_inputs else v)
            for k, v in per_block.items()}
        env: Dict[Tuple[str, str], Any] = {}
        new_state = dict(state)

        def resolve(ref: EndpointRef):
            if ref.node == "":
                return per_block[ref.endpoint]          # [B] or [B, C]
            if ref.node in prog.host_set:
                v = per_block[f"__host__{ref.node}.{ref.endpoint}"]
                if v.dim() == 2:  # [B, C] -> instance-leading [C, B]
                    v = v.transpose(0, 1)
                return v
            return env[(ref.node, ref.endpoint)]

        def payload_shape(ep):
            return ep.shape if ep.shape else (
                () if ep.channels == 1 else (ep.channels,))

        def normalize(v, count, payload, is_array):
            """Shape an edge value as the destination's block
            ((C,)?, B, *payload): payload dims align at the end, missing
            time/instance axes are prepended."""
            target = ((count,) if is_array else ()) + (B,) + payload
            v = torch.as_tensor(v)
            while v.dim() < len(target):
                tail = target[len(target) - v.dim():] if v.dim() else ()
                compatible = v.dim() > 0 and all(
                    s == t_ or s == 1 for s, t_ in zip(v.shape, tail))
                v = v[None] if compatible else v[..., None]
            return torch.broadcast_to(v, target)

        def edge_value(e, inst, ep, indexed: bool):
            """Evaluate one edge for its destination (fan-in sum, parallel
            truncation, broadcast)."""
            pre = None
            if e.fanout == Fanout.FAN_IN and e.dst_index is None \
                    and isinstance(e.source, EndpointRef):
                pre = env.get((e.source.node,
                               "__fanin__" + e.source.endpoint))
            if pre is not None:
                v = pre   # mix-down fused into the producer's kernel
            else:
                v = prog.eval_expr(e.source, resolve)
                if e.dst_index is None:
                    if e.fanout == Fanout.FAN_IN:
                        v = torch.sum(v, dim=0)  # instance axis leads
                    elif e.fanout == Fanout.REPEAT:
                        v = torch.repeat_interleave(v, e.factor, dim=0)
                    elif e.fanout == Fanout.SEGMENT_SUM:
                        v = prog.segment_sum(v, e.factor)
            is_array = not indexed and inst.count > 1
            count = 1 if indexed else inst.count
            if is_array and e.fanout == Fanout.PARALLEL and v.dim() >= 1 \
                    and v.shape[0] not in (count, B):
                v = v[:count]
            return normalize(v, count, payload_shape(ep), is_array)

        def default_block(inst, ep):
            full = ((inst.count,) if inst.count > 1 else ()) \
                + (B,) + payload_shape(ep)
            return torch.full(full, float(ep.default or 0.0),
                              dtype=torch.float32, device=prog.device)

        def gather_block(name: str) -> Dict[str, Any]:
            inst = ir.nodes[name]
            ins: Dict[str, Any] = {}
            for ep in inst.node.INPUTS:
                if ep.kind in (Kind.EVENT, Kind.ASSET):
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
            endpoint leaf is staged as [1] (the rest literals or
            arithmetic on them)."""
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
                return False

            out = set()
            for ep in ir.nodes[name].node.INPUTS:
                if ep.kind in (Kind.EVENT, Kind.ASSET):
                    continue
                if all(expr_const(e.source) and not e.is_feedback
                       for e in prog.edges_by_dst.get((name, ep.name), [])):
                    out.add(ep.name)
            return frozenset(out)

        def run_node(name: str) -> None:
            inst = ir.nodes[name]
            node = inst.node
            sr = prog.scaled_sr(inst)
            ins = gather_block(name)
            evs = {ep.name: ev_bufs[f"{name}.{ep.name}"]
                   for ep in node.INPUTS if ep.kind == Kind.EVENT
                   and f"{name}.{ep.name}" in ev_bufs
                   and ev_bufs[f"{name}.{ep.name}"].capacity > 0}
            st = new_state[name]
            kw = {"const_ins": const_eps(name)} if name in takes_const \
                else {}
            batched = None
            if inst.count > 1 and not evs and hasattr(
                    node, "process_block_batched"):
                # voice-batched kernel path (None: take process_block)
                batched = node.process_block_batched(
                    st, ins, evs, sr, B,
                    fanin_eps=fanin_only.get(name, frozenset()))
            if batched is not None:
                explain.note(path="batched")
                st, outs = batched
            elif inst.count > 1:
                if not node.BATCHED:
                    raise NotImplementedError(
                        f"node array '{name}' ({type(node).__name__}) has "
                        f"no instance-batched block path in the port yet")
                # the JAX package's name for this path (it vmaps there)
                explain.note(path="vmap")
                st, outs = node.process_block(st, ins, evs, sr, B, **kw)
            else:
                explain.note(path="block")
                if node.BATCHED:
                    st1, ins1, evs1 = _add_instance_axis(st, ins, evs)
                    st, outs = node.process_block(st1, ins1, evs1, sr, B,
                                                  **kw)
                    st = tree_map(lambda x: x[0], st)
                    outs = {k: v[0] for k, v in outs.items()}
                else:
                    st, outs = node.process_block(st, ins, evs, sr, B, **kw)
            new_state[name] = st
            for k, v in outs.items():
                env[(name, k)] = v  # [C, B, ...] / [B, ...]

        for name in order:
            with explain.processing(name):
                run_node(name)

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
            v = prog.eval_expr(expr, resolve)
            want = 1 if o.channels == 1 else 2
            while v.dim() > want:
                v = torch.sum(v, dim=0)
            outs[o.name] = v
        return new_state, outs

    return block_fn
