"""Graph compiler: IR → block function over torch tensors on one device.

Counterpart of ``oscen_tpu/graph/compile.py``.  The reference emits Rust
whose ``process_block`` advances every node one sample in topological
order (codegen/mod.rs:539, emit_frame.rs).  Here a block function runs
eagerly on the device given to ``compile``, in one of two modes:

- **sample mode** (``CompiledGraph``'s default, as in the JAX package) —
  ``_SampleStep`` replays the reference's per-sample schedule (edge
  assignments → event dispatch → node tick, in topological order) once per
  sample: op-order parity with the reference, every node array's ticks
  broadcast over its instance axis.  The JAX package scans the step with
  ``lax.scan``; the port loops over the samples in Python, so a sample
  costs one eager launch per tensor op.
- **block mode** (``Graph.compile``'s default) — each node's
  time-vectorized ``process_block`` runs over whole ``[B]`` blocks
  (graph/block_mode.py); a feedback cycle that does not dissolve runs as a
  per-sample scan island.

The host↔device split mirrors the reference's control-thread↔audio-thread
boundary: host-domain nodes (MIDI parsing, voice allocation) run in Python
per block and stage dense per-sample arrays and static event buffers to
the device in ONE host-to-device copy per block.  Blocks whose control
plane is idle reuse the staged tensors, which stay on the device, so a
steady block is one call of the block function.

Multirate regions run as in the JAX package's block mode: a node at
``rate=N`` processes ``B*N`` samples per block, each cross-rate edge carries
a resampler (``ops/resample.py``) whose state lives in ``state["__rs__"]``,
and event offsets into an oversampled node are scaled by ``N`` on the host.
Feedback edges read the previous sample through the carries in
``state["__fb__"]``.  In sample mode an oversampled region runs the
reference's inner loop: each up edge's resampler turns one outer sample
into N inner ones, the inner nodes tick N times, and each down edge's
resampler turns N inner samples into one (emit_frame.rs:114-176).

Nothing in a per-sample loop reads the card: events are applied at the
``(t, slot)`` pairs the host staged them at (``EventBuffer.slots``), and
node state is copied once per block where a tick writes in place (the
Delay's ring, ``Node.own_state``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.events import EventBuffer, EventInstance
from ..core.ramp import ValueRampState
from ..core.types import (DEFAULT_MAX_BLOCK_SIZE,
                          MAX_STATIC_EVENTS_PER_ENDPOINT, Kind, Policy,
                          SampleRate)
from ..ops import resample as _rs
from . import explain
from .ir import (BinOp, Call, Const, EdgeKernel, EndpointRef, Expr, Fanout,
                 FrameCtor, IrEdge, IrGraph, IrNodeInst)
from .node import StepValue, apply_node_events, tree_map

__all__ = ["CompiledGraph", "resolve_device"]


class _StepStack:
    """Marker wrapper for a (3, C) base/target/offset step-staging array
    built in ``_host_prepass`` (see graph/node.py StepValue)."""

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = data


# shared immutable empty event sequence (host_process inputs are
# read-only by contract; a tuple makes accidental mutation an error)
_EMPTY_EVS: tuple = ()


def _round_capacity(n: int) -> int:
    """Pad event-buffer capacity to a power of two (few distinct shapes)."""
    if n == 0:
        return 0
    c = 1
    while c < n:
        c *= 2
    return c


# ===================================================================== #
# Program: static schedule extracted from the IR
# ===================================================================== #
class _Program:
    def __init__(self, ir: IrGraph, sample_rate: float,
                 device: torch.device, block_size: Optional[int] = None):
        self.ir = ir
        self.sr = SampleRate(float(sample_rate))
        self.device = device
        # block mode only: block-size-dependent state (init_block_state)
        self.block_size = block_size
        # the host copies of the state leaves a node names in HOST_MIRROR,
        # as init_device_state built them
        self.init_mirrors: Dict[str, Dict[str, int]] = {}
        # read-only constants of the per-sample loops, filled on the device
        # once (a fill per sample would be a launch per sample)
        self._consts: Dict[Any, torch.Tensor] = {}
        self.host_nodes: List[str] = [
            n for n in ir.order if ir.nodes[n].node.HOST]
        self.device_nodes: List[str] = [
            n for n in ir.order if not ir.nodes[n].node.HOST]
        self.host_set = set(self.host_nodes)

        # a resampler per cross-rate edge (reference dispatch tables:
        # stream Default -> sinc FIR, value Default -> latch)
        self.resamplers: Dict[int, Any] = {}
        self.edge_ids: Dict[int, int] = {}
        for idx, e in enumerate(ir.edges):
            self.edge_ids[id(e)] = idx
            if e.kernel not in (EdgeKernel.UP, EdgeKernel.DOWN):
                continue
            if e.policy == Policy.DEFAULT:
                pol = "latch" if e.kind == Kind.VALUE else "sinc"
            else:
                pol = e.policy.value
            make = (_rs.make_upsampler if e.kernel == EdgeKernel.UP
                    else _rs.make_downsampler)
            self.resamplers[idx] = make(pol, e.rate_factor)

        # edges grouped by destination (declaration order preserved)
        self.edges_by_dst: Dict[Tuple[str, str], List[IrEdge]] = {}
        for e in ir.edges:
            self.edges_by_dst.setdefault(
                (e.dst_node, e.dst_endpoint), []).append(e)

        # feedback carries: endpoints read from the previous sample
        self.fb_keys: List[Tuple[str, str]] = []
        for e in ir.edges:
            if e.is_feedback and e.src_reads_state:
                for r in e.source.endpoints():
                    if r.node and (r.node, r.endpoint) not in self.fb_keys:
                        self.fb_keys.append((r.node, r.endpoint))

        # device event endpoints (consume staged EventBuffers)
        self.event_endpoints: List[Tuple[str, str]] = [
            (name, ep.name) for name in self.device_nodes
            for ep in ir.nodes[name].node.INPUTS if ep.kind == Kind.EVENT]

        # host node arrays get independent per-instance control state
        self.host_instances: Dict[str, list] = {
            name: [copy.deepcopy(ir.nodes[name].node)
                   for _ in range(ir.nodes[name].count)]
            for name in self.host_nodes if ir.nodes[name].count > 1}

        for e in ir.edges:
            if e.dst_node in self.host_set:
                for r in e.source.endpoints():
                    if r.node and r.node not in self.host_set:
                        raise ValueError(
                            f"device node '{r.node}' cannot feed host-domain "
                            f"node '{e.dst_node}' (host nodes are control-"
                            f"rate, like the reference's event phase)")

    def init_device_state(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {}
        for name in self.device_nodes:
            inst = self.ir.nodes[name]
            s = inst.node.init_state(self.scaled_sr(inst))
            # block-size-dependent extensions (the Convolver's FDL spectra
            # and partition state); only in block mode
            init_blk = getattr(inst.node, "init_block_state", None)
            if init_blk is not None and self.block_size:
                s = {**s, **init_blk(self.scaled_sr(inst),
                                     int(self.block_size))}
            mirror = getattr(inst.node, "HOST_MIRROR", ())
            if mirror:   # read on the host, before the upload
                self.init_mirrors[name] = {k: int(s[k]) for k in mirror}
            s = tree_map(lambda x: x.to(self.device), s)
            if inst.count > 1:
                s = tree_map(lambda x: x.expand(
                    (inst.count,) + tuple(x.shape)).clone(), s)
            state[name] = s
        fb = {}
        for (n, ep) in self.fb_keys:
            inst = self.ir.nodes[n]
            decl = inst.node.output(ep)
            shape = decl.shape if decl.shape else (
                () if decl.channels == 1 else (decl.channels,))
            if inst.count > 1:
                shape = (inst.count,) + shape
            fb[f"{n}.{ep}"] = torch.zeros(shape, dtype=torch.float32,
                                          device=self.device)
        state["__fb__"] = fb
        rs = {}
        for idx, kern in self.resamplers.items():
            like = torch.zeros(
                (1,) + self.edge_payload_shape(self.ir.edges[idx]))
            rs[str(idx)] = tree_map(lambda x: x.to(self.device),
                                    kern.init_state(like))
        state["__rs__"] = rs
        return state

    def edge_payload_shape(self, e: IrEdge) -> tuple:
        """Trailing (non-time) shape a cross-rate edge carries: the
        channel axes, then the instance axis of a node array (resamplers
        broadcast over trailing axes)."""
        inst = self.ir.nodes[e.dst_node]
        ep = inst.node.input(e.dst_endpoint)
        payload = ep.shape if ep.shape else (
            () if ep.channels == 1 else (ep.channels,))
        if inst.count > 1 and e.dst_index is None:
            payload = payload + (inst.count,)
        return payload

    def scaled_sr(self, inst: IrNodeInst) -> SampleRate:
        return SampleRate(self.sr.hz * inst.rate)

    def eval_expr(self, expr: Expr, resolve) -> Any:
        """Evaluate a connection expression; ``resolve(ref)`` supplies
        endpoint values."""
        if isinstance(expr, Const):
            # filled on the device, once: torch.tensor(value, device=cuda)
            # is a synchronizing host-to-device copy
            return self.const(expr.value)
        if isinstance(expr, EndpointRef):
            v = resolve(expr)
            if expr.index is not None:
                v = v[expr.index]
            if expr.channel is not None:
                v = v[..., expr.channel]
            return v
        if isinstance(expr, BinOp):
            a = self.eval_expr(expr.lhs, resolve)
            b = self.eval_expr(expr.rhs, resolve)
            return {"+": lambda: a + b, "-": lambda: a - b,
                    "*": lambda: a * b, "/": lambda: a / b}[expr.op]()
        if isinstance(expr, Call):
            return expr.fn(*[self.eval_expr(a, resolve) for a in expr.args])
        if isinstance(expr, FrameCtor):
            chans = [self.eval_expr(c, resolve) for c in expr.channels]
            shape = torch.broadcast_shapes(*[c.shape for c in chans])
            return torch.stack([c.expand(shape) for c in chans], dim=-1)
        raise TypeError(f"bad expression {expr!r}")

    def const(self, value: float, shape: tuple = ()) -> torch.Tensor:
        """A float32 constant on the device, filled once.  Callers never
        write into it."""
        key = (float(value), tuple(shape))
        c = self._consts.get(key)
        if c is None:
            c = torch.full(shape, float(value), dtype=torch.float32,
                           device=self.device)
            self._consts[key] = c
        return c

    @staticmethod
    def segment_sum(v, factor: int) -> Any:
        """Per-outer-instance fan-in for arrays flattened out of array
        subgraphs: (g*m, ...) -> (g, ...) summing each m-segment."""
        return v.reshape((v.shape[0] // factor, factor)
                         + tuple(v.shape[1:])).sum(dim=1)

    # ----------------------------------------------------------------- #
    # per-sample input gathering (sample mode; JAX compile.py:240-322)
    # ----------------------------------------------------------------- #
    def gather_inputs(self, name: str, resolve_for_edge,
                      override=None) -> Dict[str, Any]:
        """One sample's inputs of ``name``: every edge into it evaluated
        (connect, and the fan-in sum of several edges,
        static_context.rs:160-217), unconnected inputs at their defaults,
        broadcast for node arrays.  ``override(edge)`` may supply an
        already destination-shaped value (cross-rate edges in the
        multirate schedule)."""
        inst = self.ir.nodes[name]
        ins: Dict[str, Any] = {}
        for ep in inst.node.INPUTS:
            if ep.kind in (Kind.EVENT, Kind.ASSET):
                continue
            val = None
            for e in self.edges_by_dst.get((name, ep.name), []):
                v = override(e) if override is not None else None
                if v is None:
                    v = self.eval_expr(e.source, resolve_for_edge(e))
                    if e.fanout == Fanout.FAN_IN and e.dst_index is None:
                        v = torch.sum(v, dim=0)
                    if e.dst_index is None:
                        if e.fanout == Fanout.BROADCAST or (
                                inst.count > 1
                                and e.fanout == Fanout.SCALAR):
                            v = self._broadcast_to_count(v, inst.count)
                        elif e.fanout == Fanout.PARALLEL:
                            v = self._truncate_parallel(v, inst.count)
                        elif e.fanout == Fanout.REPEAT:
                            v = torch.repeat_interleave(v, e.factor, dim=0)
                        elif e.fanout == Fanout.SEGMENT_SUM:
                            v = self.segment_sum(v, e.factor)
                if e.dst_index is not None:
                    base = val if val is not None else \
                        self._default_value(inst, ep)
                    val = base.clone()
                    val[e.dst_index] = v
                elif val is None:
                    val = v
                else:
                    val = val + v   # accumulate (stream fan-in sum)
            ins[ep.name] = val if val is not None else \
                self._default_value(inst, ep)
        return ins

    def normalize_for_dst(self, e: IrEdge, v):
        """Apply the fanout transforms that give the destination's
        per-sample shape ``(count?, *payload)``."""
        inst = self.ir.nodes[e.dst_node]
        ep = inst.node.input(e.dst_endpoint)
        if e.fanout == Fanout.FAN_IN and e.dst_index is None:
            v = torch.sum(v, dim=0)
        if e.dst_index is None and inst.count > 1:
            if e.fanout in (Fanout.BROADCAST, Fanout.SCALAR, Fanout.FAN_IN):
                v = self._broadcast_to_count(v, inst.count)
            elif e.fanout == Fanout.PARALLEL:
                v = self._truncate_parallel(v, inst.count)
            elif e.fanout == Fanout.REPEAT:
                v = torch.repeat_interleave(v, e.factor, dim=0)
            elif e.fanout == Fanout.SEGMENT_SUM:
                v = self.segment_sum(v, e.factor)
        return v

    def _default_value(self, inst: IrNodeInst, ep) -> torch.Tensor:
        shape = ep.shape if ep.shape else (
            () if ep.channels == 1 else (ep.channels,))
        if inst.count > 1:
            shape = (inst.count,) + tuple(shape)
        return self.const(float(ep.default or 0.0), tuple(shape))

    @staticmethod
    def _broadcast_to_count(v, count: int) -> torch.Tensor:
        return v.expand((count,) + tuple(v.shape))

    @staticmethod
    def _truncate_parallel(v, count: int) -> torch.Tensor:
        # min-truncation on count mismatch (ir/graph.rs:48-78)
        return v[:count] if v.shape[0] != count else v


# ===================================================================== #
# Sample-mode step
# ===================================================================== #
class _SampleStep:
    """The per-sample body — the ``__advance_one_frame`` analogue
    (emit_frame.rs:29-108 same-rate, :95-108 + :114-176 multirate), called
    once per sample of the block."""

    def __init__(self, prog: _Program):
        self.prog = prog
        ir = prog.ir
        self.inner_nodes = [n for n in prog.device_nodes
                            if ir.nodes[n].rate != 1]
        rates = {ir.nodes[n].rate for n in self.inner_nodes}
        if len(rates) > 1:
            raise ValueError(
                "mixed oversampling factors in one graph are unsupported "
                "(the reference rejects mixed inner rates, "
                "lower.rs:797-809)")
        self.inner_rate = rates.pop() if rates else 1
        self.up_edges = [e for e in ir.edges if e.kernel == EdgeKernel.UP]
        self.down_edges = [e for e in ir.edges
                           if e.kernel == EdgeKernel.DOWN]
        # taint: outer consumers (transitive) of Down-edge outputs run
        # after the inner loop (emit_node.rs:516-584)
        tainted = {e.dst_node for e in self.down_edges}
        changed = True
        while changed:
            changed = False
            for e in ir.edges:
                if e.is_feedback or e.dst_node in tainted:
                    continue
                if {r.node for r in e.source.endpoints() if r.node} \
                        & tainted:
                    tainted.add(e.dst_node)
                    changed = True
        for e in self.up_edges:
            if {r.node for r in e.source.endpoints() if r.node} & tainted:
                raise ValueError(
                    "down-then-up diamond (an oversampled region fed from "
                    "a downsampled signal) is rejected, as in the "
                    "reference (emit_node.rs:516-584)")
        outer = [n for n in prog.device_nodes if ir.nodes[n].rate == 1]
        self.pre_nodes = [n for n in outer if n not in tainted]
        self.post_nodes = [n for n in outer if n in tainted]

    def own(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The state a block's loop carries (``Node.own_state`` of every
        device node)."""
        ir = self.prog.ir
        return {**state, **{n: ir.nodes[n].node.own_state(state[n])
                            for n in self.prog.device_nodes}}

    def _run_node(self, new_state, env, name, t_ev, ev_bufs, resolver,
                  override=None):
        prog = self.prog
        inst = prog.ir.nodes[name]
        node = inst.node
        sr = prog.scaled_sr(inst)
        ins = prog.gather_inputs(name, resolver, override)
        st = apply_node_events(node, new_state[name], name, ev_bufs, t_ev,
                               sr, ins)
        st, outs = node.tick_owned(st, ins, sr)
        new_state[name] = st
        for k, v in outs.items():
            env[(name, k)] = v

    def _resample(self, e: IrEdge, rs, x):
        """Edge ``e``'s resampler over ``x`` (``[n, (C,) *payload]``): a
        node array's instance axis moves behind the payload for it, as in
        block mode."""
        prog = self.prog
        idx = prog.edge_ids[id(e)]
        array = prog.ir.nodes[e.dst_node].count > 1 and e.dst_index is None
        if array:
            x = x.movedim(1, -1)
        rs[str(idx)], y = prog.resamplers[idx].process_block(rs[str(idx)], x)
        return y.movedim(-1, 1) if array else y

    def __call__(self, state: Dict[str, Any], t: int,
                 per_sample: Dict[str, Any], ev_bufs: Dict[str, Any]
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        prog = self.prog
        ir = prog.ir
        env: Dict[Tuple[str, str], Any] = {}
        fb_prev = state["__fb__"]

        def resolve(ref: EndpointRef):
            if ref.node == "":
                return per_sample[ref.endpoint]
            if ref.node in prog.host_set:
                return per_sample[f"__host__{ref.node}.{ref.endpoint}"]
            v = env.get((ref.node, ref.endpoint))
            if v is not None:
                return v
            # a source not yet computed this sample (a feedback edge): the
            # previous sample's value
            return fb_prev[f"{ref.node}.{ref.endpoint}"]

        def resolver(edge: Optional[IrEdge]):
            return resolve

        new_state = dict(state)
        if not self.inner_nodes:
            for name in prog.device_nodes:
                self._run_node(new_state, env, name, t, ev_bufs, resolver)
        else:
            # ---- multirate schedule (emit_frame.rs:114-176) ----------
            N = self.inner_rate
            rs = dict(new_state["__rs__"])
            for name in self.pre_nodes:
                self._run_node(new_state, env, name, t, ev_bufs, resolver)
            # up-warmup: one outer value in, N inner values out per edge
            up_vals: Dict[int, Any] = {}
            for e in self.up_edges:
                v = prog.normalize_for_dst(
                    e, prog.eval_expr(e.source, resolver(e)))
                up_vals[id(e)] = self._resample(e, rs, v[None])
            # the inner loop, N ticks
            down_collect: Dict[int, list] = {id(e): []
                                             for e in self.down_edges}
            for i in range(N):
                def override_up(e, i=i):
                    if e.kernel == EdgeKernel.UP:
                        return up_vals[id(e)][i]
                    return None
                for name in self.inner_nodes:
                    self._run_node(new_state, env, name, t * N + i, ev_bufs,
                                   resolver, override_up)
                for e in self.down_edges:
                    down_collect[id(e)].append(prog.normalize_for_dst(
                        e, prog.eval_expr(e.source, resolver(e))))
            # down-finalize: N inner values in, one outer value out
            down_vals = {id(e): self._resample(
                e, rs, torch.stack(down_collect[id(e)]))[0]
                for e in self.down_edges}

            def override_down(e):
                if e.kernel == EdgeKernel.DOWN:
                    return down_vals[id(e)]
                return None
            for name in self.post_nodes:
                self._run_node(new_state, env, name, t, ev_bufs, resolver,
                               override_down)
            new_state["__rs__"] = rs

        # refresh feedback carries with this sample's outputs
        new_state["__fb__"] = {**fb_prev, **{
            f"{n}.{ep}": env[(n, ep)] for (n, ep) in prog.fb_keys}}

        outs = {}
        for o in ir.outputs:
            if o.kind == Kind.EVENT:
                continue   # event outputs are routed host-side
            expr = ir.output_edges.get(o.name)
            if expr is None:
                shape = () if o.channels == 1 else (o.channels,)
                outs[o.name] = prog.const(0.0, shape)
                continue
            v = prog.eval_expr(expr, resolver(None))
            # fan-in at the graph output: array-sourced outputs mix down
            # by summation (emit_edge.rs:67-84)
            want = 0 if o.channels == 1 else 1
            while v.dim() > want:
                v = torch.sum(v, dim=0)
            outs[o.name] = v
        return new_state, outs


def resolve_device(device) -> torch.device:
    """The device a compiled graph or a carried state lives on: ``"cuda"``
    (the default of every entry point) or ``"cpu"``, which a caller asks
    for by name.  ``"cuda"`` without a card raises; nothing falls back to
    the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} (the default) needs a CUDA card, and "
            f"torch sees none; pass device='cpu' to run on the CPU")
    return dev


# ===================================================================== #
# CompiledGraph — stateful host wrapper
# ===================================================================== #
class CompiledGraph:
    """Runtime handle: host param/event staging plus the device block
    function.  ``init``, per-input setters (``set_value`` /
    ``set_value_with_ramp`` / ``queue_event``), and ``process_block``
    (sample-accurate events and ramps), as in the JAX package.  ``state``
    is a nested dict of tensors on ``device`` with the JAX state's keys:
    the CUDA card unless the caller passes ``device="cpu"``.  ``mode`` is
    ``"sample"`` (the default, as in the JAX package) or ``"block"``.
    ``jit`` is accepted for the JAX package's signature and has no meaning
    here: the port runs its block functions eagerly.
    """

    def __init__(self, ir: IrGraph, sample_rate: float = 44100.0,
                 block_size: int = DEFAULT_MAX_BLOCK_SIZE,
                 mode: str = "sample", jit: bool = True, device="cuda"):
        if mode not in ("sample", "block"):
            raise ValueError(f"unknown mode {mode!r}")
        self.device = resolve_device(device)
        self.ir = ir
        self.mode = mode
        self.block_size = int(block_size)
        self.sample_rate = float(sample_rate)
        self._new_program()

        # host parameter state
        self._params: Dict[str, ValueRampState] = {}
        self._event_queues: Dict[str, List[EventInstance]] = {}
        for gi in ir.inputs:
            if gi.kind == Kind.VALUE:
                self._params[gi.name] = ValueRampState(float(gi.default))
            elif gi.kind == Kind.EVENT:
                self._event_queues[gi.name] = []

        self._state = self.prog.init_device_state()
        self._mirrors = copy.deepcopy(self.prog.init_mirrors)
        # block functions keyed on (block length, literal parameters)
        self._block_fns: Dict[Tuple[int, Tuple], Any] = {}
        # (literal parameters, their cache key); None after a setter
        self._literals: Optional[Tuple[Dict[str, float], Tuple]] = None
        # steady-state staging cache: when the control plane is idle (no
        # pending events, no param changes, no active ramps) the host
        # prepass and staging reproduce block to block, so the staged
        # device tensors are reused and a steady block is one call
        self._staging_cache: Dict[int, Any] = {}
        # per-host-node-array persistent steady outputs (see _host_prepass)
        self._host_steady: Dict[str, Any] = {}
        self._last_event_outs: Dict[str, list] = {}
        self._control_dirty = True
        # the block function of the compiled block size, built now so that
        # a graph the port cannot run (a feedback island spanning a rate
        # boundary) fails at compile time
        self._block_fn(self.block_size)

    @property
    def state(self) -> Dict[str, Any]:
        """The graph's state: a nested dict of tensors on ``device``."""
        return self._state

    @state.setter
    def state(self, new: Dict[str, Any]) -> None:
        """Take a state whose leaves may be numpy arrays (a JAX state mapped
        with ``np.asarray``, a saved checkpoint) or tensors on another
        device: each such leaf becomes a tensor on this graph's device,
        float leaves float32, integer and bool leaves in their own dtype (as
        ``utils.convert.state_from_jax`` does).  A numpy leaf is copied from
        pinned memory without waiting for the card; a tensor already on the
        device is kept as it is.  The blocks themselves write ``_state``."""
        self._state = tree_map(self._state_leaf, new)

    def _state_leaf(self, x):
        if isinstance(x, torch.Tensor):
            if self._holds(x):
                return x
            x = x.detach()
            if x.is_floating_point() and x.dtype != torch.float32:
                x = x.to(torch.float32)
            if x.device.type == "cpu" and self.device.type == "cuda":
                x = x.pin_memory()
            return x.to(self.device, non_blocking=True)
        a = np.asarray(x)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        t = torch.from_numpy(np.array(a, copy=True, order="C"))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _new_program(self) -> None:
        self.prog = _Program(
            self.ir, self.sample_rate, self.device,
            self.block_size if self.mode == "block" else None)
        # built in both modes, as in the JAX package: it rejects the graphs
        # the reference rejects (mixed inner rates, the down-then-up
        # diamond)
        self._step = _SampleStep(self.prog)

    # ------------------------------------------------------------------ #
    def init(self, sample_rate: Optional[float] = None) -> None:
        """Re-prepare: rebuild all node state at the given rate."""
        if sample_rate is not None and sample_rate != self.sample_rate:
            self.sample_rate = float(sample_rate)
            self._new_program()
            self._block_fns.clear()
        self._state = self.prog.init_device_state()
        self._mirrors = copy.deepcopy(self.prog.init_mirrors)
        self._control_dirty = True
        self._staging_cache.clear()
        self._host_steady.clear()
        for name in self.prog.host_nodes:
            self.ir.nodes[name].node.reset()
            for n in self.prog.host_instances.get(name, []):
                n.reset()
        for q in self._event_queues.values():
            q.clear()

    # ------------------------------------------------------------------ #
    # setters (generated set_x / set_x_with_ramp analogues)
    # ------------------------------------------------------------------ #
    def set_value(self, name: str, v: float) -> None:
        spec = self.ir.get_input(name).spec
        frames = spec.ramp_frames if spec else 0
        self._touch()
        if frames:
            self._params[name].set_with_ramp(v, frames)
        else:
            self._params[name].set_immediate(v)

    def set_value_immediate(self, name: str, v: float) -> None:
        self._touch()
        self._params[name].set_immediate(v)

    def set_value_with_ramp(self, name: str, v: float, frames: int) -> None:
        self._touch()
        self._params[name].set_with_ramp(v, frames)

    def _touch(self) -> None:
        """A setter ran: restage, and re-derive the literal parameters."""
        self._control_dirty = True
        self._literals = None

    def queue_event(self, name: str, frame_offset: int, payload) -> None:
        if name not in self._event_queues:
            raise KeyError(f"'{name}' is not an event input")
        self._control_dirty = True
        self._event_queues[name].append(
            EventInstance(int(frame_offset), payload))

    # ------------------------------------------------------------------ #
    # assets (publish -> take -> retire analogue; reference asset/mod.rs)
    # ------------------------------------------------------------------ #
    def publish_asset(self, external: str, a) -> None:
        """Conform an AudioAsset to the graph rate and swap it into every
        bound node's state between blocks (the control-thread publish).
        The consumers build their new leaves on the host and copy them to
        the card from pinned memory without waiting; nothing reads the
        card, and the next blocks run as before (``_run_block``)."""
        from ..assets import AssetError, AudioAsset

        bindings = [b for b in self.ir.asset_bindings if b[0] == external]
        if not bindings:
            raise KeyError(f"unknown external asset '{external}'")
        self._touch()
        self._staging_cache.clear()
        if not isinstance(a, AudioAsset):
            raise AssetError("publish_asset expects an AudioAsset")
        if a.sample_rate != int(self.sample_rate):
            a = AudioAsset.from_samples(a.channels_data, a.sample_rate,
                                        graph_rate=self.sample_rate)
        for (_, node_name, endpoint) in bindings:
            inst = self.ir.nodes[node_name]
            node = inst.node
            consume = getattr(node, "asset_consume", None)
            if consume is None:
                raise AssetError(
                    f"node '{node_name}' has no asset consumer")
            sr = self.prog.scaled_sr(inst)
            if inst.count > 1:
                # one published asset broadcast into every instance's
                # state slot (reference asset wiring is generic over
                # nodes, asset/mod.rs:309-320): consume once on instance
                # 0, then broadcast the leaves the consumer replaced;
                # leaves it left untouched (the same objects) keep their
                # per-instance values
                st = self._state[node_name]
                first = tree_map(lambda x: x[0], st)
                new_first = consume(first, a, sr)
                cnt = inst.count

                def merge(old_stacked, old_first, new_leaf):
                    if new_leaf is old_first:   # untouched by consume
                        return old_stacked
                    return new_leaf[None].expand(
                        (cnt,) + tuple(new_leaf.shape)).clone()
                self._state[node_name] = tree_map(merge, st, first,
                                                 new_first)
            else:
                self._state[node_name] = consume(
                    self._state[node_name], a, sr)
            if node_name in self._mirrors:
                self._mirrors[node_name] = node.mirror_step(
                    self._mirrors[node_name], sr, consumed=True)

    def load_wav(self, external: str, path: str) -> None:
        """Decode + conform + publish (reference AssetLoadHandle::load_wav,
        asset/mod.rs:290-294)."""
        from ..assets import AudioAsset
        self.publish_asset(
            external, AudioAsset.from_wav(path, graph_rate=self.sample_rate))

    # ------------------------------------------------------------------ #
    # host pre-pass (numpy; the same O(events) algorithm as the JAX
    # package's _host_prepass)
    # ------------------------------------------------------------------ #
    def _host_prepass(self, block_len: int
                      ) -> Tuple[Dict[str, EventBuffer],
                                 Dict[str, np.ndarray]]:
        """Run host-domain control nodes; build the device event buffers
        and host-produced value arrays (numpy)."""
        prog = self.prog
        ir = self.ir
        # (node, endpoint) -> event list (or list of per-instance lists
        # for array outputs); graph inputs live under node ""
        ev_env: Dict[Tuple[str, str], Any] = {}
        val_env: Dict[Tuple[str, str], Any] = {}
        for name, q in self._event_queues.items():
            ev_env[("", name)] = list(q)
            q.clear()

        def source_events(e: IrEdge):
            src = e.source
            if not isinstance(src, EndpointRef):
                raise ValueError("event edges must be bare endpoints")
            return ev_env.get((src.node, src.endpoint), [])

        def host_value_in(edges, ep):
            v = float(ep.default or 0.0)
            for e in edges:
                src = e.source
                if isinstance(src, Const):
                    v = src.value
                elif isinstance(src, EndpointRef) and src.node == "":
                    v = float(self._params[src.endpoint].current)
            return v

        for name in prog.host_nodes:
            inst = ir.nodes[name]
            if inst.count == 1:
                node = inst.node
                ev_in: Dict[str, list] = {}
                v_in: Dict[str, Any] = {}
                for ep in node.INPUTS:
                    edges = prog.edges_by_dst.get((name, ep.name), [])
                    if ep.kind == Kind.EVENT:
                        # event fan-in is last-write-wins per block
                        # (static_context.rs:160-217)
                        evs: List[EventInstance] = []
                        for e in edges:
                            src_evs = source_events(e)
                            if src_evs and isinstance(src_evs[0], list):
                                idx = e.source.index
                                if idx is not None:
                                    evs = list(src_evs[idx])
                                else:
                                    evs = [x for sub in src_evs
                                           for x in sub]
                            else:
                                evs = list(src_evs)
                        ev_in[ep.name] = sorted(
                            evs, key=lambda x: x.frame_offset)
                    else:
                        v_in[ep.name] = host_value_in(edges, ep)
                evs_out, vals_out = node.host_process(block_len, ev_in, v_in)
                for ep, evs in (evs_out or {}).items():
                    ev_env[(name, ep)] = evs
                for ep, arr in (vals_out or {}).items():
                    val_env[(name, ep)] = (
                        arr if isinstance(arr, StepValue)
                        else np.asarray(arr, np.float32))
                continue

            # host node array: per-instance control state.  Input
            # resolution happens once per endpoint, and only instances
            # that carry events this block or carried them last block
            # run host_process, so the prepass is O(events), not
            # O(voices).
            instances = prog.host_instances[name]
            cnt = inst.count
            node0 = instances[0]
            v_in = {}
            ev_eps: List[str] = []
            per_inst_evs: Dict[str, List[list]] = {}
            for ep in node0.INPUTS:
                edges = prog.edges_by_dst.get((name, ep.name), [])
                if ep.kind != Kind.EVENT:
                    v_in[ep.name] = host_value_in(edges, ep)
                    continue
                ev_eps.append(ep.name)
                lists: List[Any] = [_EMPTY_EVS] * cnt
                for e in edges:
                    src_evs = source_events(e)
                    is_nested = bool(src_evs) and isinstance(src_evs[0], list)
                    if e.dst_index is not None:
                        i = e.dst_index
                        if is_nested:
                            if e.source.index is not None:
                                lists[i] = src_evs[e.source.index]
                            elif i < len(src_evs):
                                lists[i] = src_evs[i]
                            else:
                                lists[i] = _EMPTY_EVS
                        else:
                            lists[i] = src_evs
                    elif is_nested:
                        if e.source.index is not None:
                            lists = [src_evs[e.source.index]] * cnt
                        else:
                            lists = [src_evs[i] if i < len(src_evs)
                                     else _EMPTY_EVS for i in range(cnt)]
                    else:
                        lists = [src_evs] * cnt
                per_inst_evs[ep.name] = lists
            active = {i for epn in ev_eps
                      for i, evs in enumerate(per_inst_evs[epn]) if evs}
            empty_in = {epn: _EMPTY_EVS for epn in ev_eps}
            hs = self._host_steady.get(name)
            if hs is None or not node0.HOST_STEADY \
                    or hs["B"] != block_len or hs["v_in"] != v_in:
                hs = {"B": block_len, "v_in": dict(v_in),
                      "ev": {}, "val": {}, "vrec": {},
                      "stale": set(range(cnt))}
                self._host_steady[name] = hs
            for i in sorted(active | hs["stale"]):
                node = instances[i]
                if i in active:
                    ev_in = {epn: sorted(per_inst_evs[epn][i],
                                         key=lambda x: x.frame_offset)
                             for epn in ev_eps}
                else:
                    ev_in = dict(empty_in)
                evs_out, vals_out = node.host_process(block_len, ev_in, v_in)
                evs_out = evs_out or {}
                # an event endpoint omitted from the result emits nothing
                for ep, lst in hs["ev"].items():
                    if ep not in evs_out:
                        lst[i] = _EMPTY_EVS
                for ep, evs in evs_out.items():
                    hs["ev"].setdefault(ep, [_EMPTY_EVS] * cnt)[i] = evs
                for ep, arr in (vals_out or {}).items():
                    # classify so the staging below is O(changes): a
                    # scalar const updates the const row, a StepValue
                    # joins the step set, anything else the full set
                    rec = hs["vrec"].get(ep)
                    if rec is None:
                        rec = {"const": np.zeros(cnt, np.float32),
                               "steps": {}, "full": {}, "irr": set()}
                        hs["vrec"][ep] = rec
                    rec["steps"].pop(i, None)
                    rec["full"].pop(i, None)
                    rec["irr"].discard(i)
                    if isinstance(arr, StepValue):
                        rec["steps"][i] = arr
                        rec["const"][i] = arr.target
                    else:
                        arr = np.asarray(arr, np.float32)
                        if arr.ndim != 1:
                            rec["irr"].add(i)
                            rec["full"][i] = arr
                        elif arr.shape[0] == 1:
                            rec["const"][i] = arr[0]
                        else:
                            rec["full"][i] = arr
                    hs["val"].setdefault(ep, [None] * cnt)[i] = arr
            hs["stale"] = set(active)
            for ep, evs in hs["ev"].items():
                ev_env[(name, ep)] = evs  # list of per-instance lists
            for ep, rec in hs["vrec"].items():
                steps = rec["steps"]
                if rec["irr"] or rec["full"]:
                    # materialize + broadcast + stack ([B, C]) — rare
                    # (several steps in a block, non-scalar payloads)
                    arrs = [a.materialize(block_len)
                            if isinstance(a, StepValue) else a
                            for a in hs["val"][ep]]
                    L = max(a.shape[0] for a in arrs)
                    arrs = [np.broadcast_to(a, (L,) + a.shape[1:])
                            for a in arrs]
                    val_env[(name, ep)] = np.stack(arrs, axis=-1)
                elif steps:
                    # single steps stage as (3, C) base/target/offset rows
                    base = rec["const"].copy()
                    tgt = rec["const"].copy()
                    off = np.full(cnt, float(block_len), np.float32)
                    for i, sv in steps.items():
                        base[i] = sv.base
                        tgt[i] = sv.target
                        off[i] = min(sv.offset, block_len - 1)
                    val_env[(name, ep)] = _StepStack(
                        np.stack([base, tgt, off]))
                else:
                    # every instance block-constant: [1, C]
                    val_env[(name, ep)] = rec["const"].reshape(1, cnt)

        # device event buffers (numpy here; staged with everything else);
        # offsets into an oversampled node count its inner samples
        # (reference EdgeKernel::Event{Multiply}, emit_frame.rs)
        ev_bufs: Dict[str, EventBuffer] = {}
        for (name, ep) in prog.event_endpoints:
            inst = ir.nodes[name]
            edges = prog.edges_by_dst.get((name, ep), [])
            if inst.count > 1:
                # last-write-wins per instance queue; dense [count, cap]
                # buffers filled only on event-bearing rows
                cnt = inst.count
                per_inst: List[Any] = [_EMPTY_EVS] * cnt
                for e in edges:
                    evs = source_events(e)
                    if e.dst_index is not None:
                        per_inst[e.dst_index] = evs
                    elif evs and isinstance(evs[0], list):
                        for i in range(min(len(evs), cnt)):
                            per_inst[i] = evs[i]
                    else:
                        per_inst = [evs] * cnt
                cap = _round_capacity(
                    max((len(v) for v in per_inst), default=0))
                off = np.zeros((cnt, cap), np.int32)
                val = np.zeros((cnt, cap), np.float32)
                ok = np.zeros((cnt, cap), bool)
                for i, evs in enumerate(per_inst):
                    if not evs:
                        continue
                    evs = sorted(evs, key=lambda x: x.frame_offset)
                    for j, ev2 in enumerate(
                            evs[:MAX_STATIC_EVENTS_PER_ENDPOINT]):
                        off[i, j] = ev2.frame_offset
                        val[i, j] = ev2.scalar
                        ok[i, j] = True
                ev_bufs[f"{name}.{ep}"] = EventBuffer(off * inst.rate, val,
                                                      ok)
            else:
                evs = []
                for e in edges:  # last-write-wins (connect semantics)
                    src_evs = source_events(e)
                    if e.source.index is not None and src_evs \
                            and isinstance(src_evs[0], list):
                        src_evs = src_evs[e.source.index]
                    evs = list(src_evs)
                buf = EventBuffer.from_events(evs, _round_capacity(len(evs)))
                if inst.rate != 1:
                    buf = EventBuffer(buf.offsets * inst.rate, buf.values,
                                      buf.valid)
                ev_bufs[f"{name}.{ep}"] = buf

        host_vals = {}
        for (n, ep), arr in val_env.items():
            if isinstance(arr, _StepStack):
                host_vals[f"__hstep__{n}.{ep}"] = arr.data     # (3, C)
            elif isinstance(arr, StepValue):
                host_vals[f"__hstep__{n}.{ep}"] = np.array(
                    [arr.base, arr.target, min(arr.offset, block_len - 1)],
                    np.float32)
            else:
                host_vals[f"__host__{n}.{ep}"] = arr

        # graph event outputs (routed host-side)
        self._last_event_outs = {}
        for o in ir.outputs:
            if o.kind != Kind.EVENT:
                continue
            expr = ir.output_edges.get(o.name)
            self._last_event_outs[o.name] = list(
                ev_env.get((expr.node, expr.endpoint), [])) \
                if isinstance(expr, EndpointRef) else []
        return ev_bufs, host_vals

    # ------------------------------------------------------------------ #
    def _literal_params(self) -> Dict[str, float]:
        """Values of the graph value inputs never set since compile (they
        still hold their defaults): the nodes' ``literal_ins`` may
        specialize on them, e.g. a pivot whose ``filter_env_amount`` was
        never raised runs the cutoff-modulation MulAdd as a constant, so
        the filter hoists its coefficients.  The parameters stay staged as
        data; only branch decisions use the literals.  The first setter of
        a parameter drops it from the set, and the block function for the
        new set is built once (the JAX package keys its trace cache the
        same way)."""
        if self._literals is None:
            lits = {name: float(r.current)
                    for name, r in self._params.items() if not r.touched}
            self._literals = (lits, tuple(sorted(lits.items())))
        return self._literals[0]

    def _host_params(self) -> Dict[str, float]:
        """Current host values of the graph value inputs (``host_ins``; a
        block reads only those staged as block-constant ``[1]``)."""
        return {name: float(r.current) for name, r in self._params.items()}

    def _block_fn(self, B: int):
        if self.mode == "sample":
            fn = self._block_fns.get(B)
            if fn is None:
                fn = self._block_fns[B] = self._make_scan_fn(B)
            return fn
        lits = self._literal_params()
        key = (B, self._literals[1])
        fn = self._block_fns.get(key)
        if fn is None:
            from .block_mode import make_block_fn
            fn = make_block_fn(self.prog, B, literal_params=lits,
                               host_params=self._host_params,
                               host_mirrors=lambda: self._mirrors)
            self._block_fns[key] = fn
        return fn

    def _make_scan_fn(self, block_len: int):
        """The sample-mode block function: the per-sample step over the
        block (the JAX package's ``lax.scan``, here a Python loop).  Step
        values are expanded and ``[1]``-staged parameters broadcast to
        ``[B]`` first; each sample reads views of them."""
        from .block_mode import reconstruct_step_values
        step = self._step
        B = block_len

        def block_fn(state, per_block, ev_bufs):
            per_block = reconstruct_step_values(per_block, B)
            per_block = {
                k: (v.expand((B,) + tuple(v.shape[1:]))
                    if v.dim() >= 1 and v.shape[0] == 1 and B != 1 else v)
                for k, v in per_block.items()}
            for n in self.prog.device_nodes:
                explain.note(node=n, path="tick")
            state = step.own(state)
            outs: Dict[str, list] = {}
            for t in range(B):
                state, o = step(state, t,
                                {k: v[t] for k, v in per_block.items()},
                                ev_bufs)
                for k, v in o.items():
                    outs.setdefault(k, []).append(v)
            return state, {k: torch.stack(v) for k, v in outs.items()}

        return block_fn

    def _control_steady(self) -> bool:
        """True when block-to-block staging is reproducible: no pending
        control changes, no active ramps, and every host node declares
        itself event-driven (``HOST_STEADY``)."""
        if self._control_dirty:
            return False
        if any(r.frames_remaining > 0 for r in self._params.values()):
            return False
        return all(getattr(self.ir.nodes[n].node, "HOST_STEADY", False)
                   for n in self.prog.host_nodes)

    def _to_device(self, arrays: Dict[Any, np.ndarray]
                   ) -> Dict[Any, torch.Tensor]:
        """All staged arrays in ONE host-to-device copy: packed into one
        float32 buffer (pinned on CUDA, copied non-blocking) and sliced
        back into views on the device.  Event offsets ride as f32 (exact
        below 2**24) and the valid masks as 0/1."""
        flat = [np.asarray(a, np.float32).ravel() for a in arrays.values()]
        n = sum(f.size for f in flat)
        if self.device.type == "cuda":
            host = torch.empty((n,), dtype=torch.float32, pin_memory=True)
            if n:
                np.concatenate(flat, out=host.numpy())
            packed = host.to(self.device, non_blocking=True)
        else:
            packed = torch.from_numpy(
                np.concatenate(flat) if flat else np.zeros(0, np.float32))
        out, pos = {}, 0
        for k, a in arrays.items():
            size = int(np.prod(np.shape(a)))
            out[k] = packed[pos:pos + size].reshape(np.shape(a))
            pos += size
        return out

    def _holds(self, t: torch.Tensor) -> bool:
        """True when ``t`` lies on this graph's device (``"cuda"`` names the
        current card, which a tensor reports with its index)."""
        d = self.device
        if t.device.type != d.type:
            return False
        if d.type == "cuda" and d.index is None:
            return t.device.index == torch.cuda.current_device()
        return t.device == d

    def _stage(self, B: int, ev_np: Dict[str, EventBuffer],
               host_vals: Dict[str, np.ndarray], stream_inputs=None):
        """Per-block staging: graph params (materialized ramps), stream
        inputs, host values and event buffers, in one transfer.  A stream
        input that is already a tensor on the graph's device (another
        graph's output, say) is not copied: it is padded to B with zeros
        on the device and used as it is."""
        arrays: Dict[Any, np.ndarray] = {}
        on_device: Dict[str, torch.Tensor] = {}
        for gi in self.ir.inputs:
            if gi.kind == Kind.VALUE:
                arrays[("pb", gi.name)] = \
                    self._params[gi.name].materialize_block(B)
            elif gi.kind == Kind.STREAM:
                shape = (B,) if gi.channels == 1 else (B, gi.channels)
                src = (stream_inputs or {}).get(gi.name)
                if isinstance(src, torch.Tensor) and self._holds(src):
                    x = src[:B].to(torch.float32)
                    if x.shape[0] < B:   # short tails pad with zeros
                        x = torch.cat([x, torch.zeros(
                            (B - x.shape[0],) + tuple(x.shape[1:]),
                            dtype=torch.float32, device=self.device)])
                    on_device[gi.name] = x
                    continue
                arr = np.zeros(shape, np.float32)
                if src is not None:
                    if isinstance(src, torch.Tensor):
                        src = src.detach().cpu()
                    src = np.asarray(src, np.float32)[:B]
                    arr[:src.shape[0]] = src   # short tails pad with zeros
                arrays[("pb", gi.name)] = arr
        for k, arr in host_vals.items():
            arrays[("pb", k)] = arr
        for k, b in ev_np.items():
            arrays[("off", k)] = b.offsets
            arrays[("val", k)] = b.values
            arrays[("ok", k)] = b.valid
        dev = self._to_device(arrays)
        per_block = {k: v for (kind, k), v in dev.items() if kind == "pb"}
        per_block.update(on_device)
        ev_bufs = {k: EventBuffer(dev[("off", k)].to(torch.int32),
                                  dev[("val", k)], dev[("ok", k)] > 0.5,
                                  EventBuffer.host_slots(b.offsets, b.valid))
                   for k, b in ev_np.items()}
        return per_block, ev_bufs

    def _run_block(self, B: int, per_block, ev_bufs) -> Dict[str, Any]:
        """One call of the block function on the current state; then the
        host mirrors advance by the block (each node by its own samples)."""
        self._state, outs = self._block_fn(B)(self._state, per_block,
                                              ev_bufs)
        for name, m in self._mirrors.items():
            inst = self.ir.nodes[name]
            self._mirrors[name] = inst.node.mirror_step(
                m, self.prog.scaled_sr(inst), B * inst.rate)
        return outs

    def process_block(self, block_len: Optional[int] = None,
                      stream_inputs: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
        """Advance one block; returns {output name: [B(,C)] tensor on the
        device, event output name: event list}."""
        B = int(block_len or self.block_size)
        steady = stream_inputs is None and self._control_steady()
        if steady and B in self._staging_cache:
            return dict(self._run_block(B, *self._staging_cache[B]))
        self._control_dirty = False  # staging below consumes everything
        ev_np, host_vals = self._host_prepass(B)
        per_block, ev_bufs = self._stage(B, ev_np, host_vals, stream_inputs)
        # a clean-entry block's staging reproduces verbatim until the
        # next control change: keep it on the device
        self._staging_cache = {B: (per_block, ev_bufs)} if steady else {}
        outs = dict(self._run_block(B, per_block, ev_bufs))
        outs.update(self._last_event_outs)
        return outs

    # ------------------------------------------------------------------ #
    def render(self, num_frames: int,
               stream_inputs: Optional[Dict[str, Any]] = None,
               tail: int = 0) -> Dict[str, np.ndarray]:
        """Offline render (BlockRender analogue, graph/offline.rs:19-113):
        chunked block processing, input padding, tail silence; numpy
        outputs."""
        total = int(num_frames) + int(tail)
        chunks: List[Dict[str, Any]] = []
        pos = 0
        while pos < total:
            n = min(self.block_size, total - pos)
            si = None
            if stream_inputs:
                si = {k: (v[pos:pos + n] if isinstance(v, torch.Tensor)
                          else np.asarray(v)[pos:pos + n])
                      for k, v in stream_inputs.items()}
            chunks.append(self.process_block(n, si))
            pos += n
        return {o.name: np.concatenate(
                    [c[o.name].cpu().numpy() for c in chunks],
                    axis=0)[:total]
                for o in self.ir.outputs if o.kind != Kind.EVENT}

    def render_mono(self, num_frames: int, **kw) -> np.ndarray:
        outs = self.render(num_frames, **kw)
        if len(outs) != 1:
            raise ValueError("render_mono requires exactly one output")
        return next(iter(outs.values()))

    def _steady_staging(self, B: int):
        """Event-free staging at the CURRENT parameter values (shared by
        render_steady / steady_checksum / explain)."""
        ev_np, host_vals = self._host_prepass(B)
        return self._stage(B, ev_np, host_vals)

    def render_steady(self, num_blocks: int,
                      block_len: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
        """Steady-state rendering with parameters frozen at their current
        values: one staging, then ``num_blocks`` calls of the block
        function; outputs stay on the device, concatenated in time."""
        B = int(block_len or self.block_size)
        per_block, ev_bufs = self._steady_staging(B)
        chunks = [self._run_block(B, per_block, ev_bufs)
                  for _ in range(int(num_blocks))]
        return {k: torch.cat([c[k] for c in chunks], dim=0)
                for k in (chunks[0] if chunks else {})}

    def steady_checksum(self, num_blocks: int,
                        block_len: Optional[int] = None) -> float:
        """Render ``num_blocks`` steady-state blocks and return only the
        energy checksum (sum of squares of every stream output sample),
        accumulated on the device and read once at the end."""
        B = int(block_len or self.block_size)
        per_block, ev_bufs = self._steady_staging(B)
        stream_outs = [o.name for o in self.ir.outputs
                       if o.kind != Kind.EVENT]
        acc = torch.zeros((), dtype=torch.float32, device=self.device)
        for _ in range(int(num_blocks)):
            outs = self._run_block(B, per_block, ev_bufs)
            acc = acc + sum(torch.sum(outs[nm] ** 2) for nm in stream_outs)
        return float(acc.item())

    def node_state(self, name: str):
        """A node's current state (nested dict of tensors)."""
        return self._state[name]

    def latency_samples(self) -> int:
        """Total base-rate latency of the cross-rate Down edges (reference
        emit_struct.rs:534-570: each down kernel's latency divided by its
        rate factor)."""
        return sum(kern.latency_samples() // self.ir.edges[idx].rate_factor
                   for idx, kern in self.prog.resamplers.items()
                   if self.ir.edges[idx].kernel == EdgeKernel.DOWN)

    def explain(self, block_len: Optional[int] = None,
                formatted: bool = False):
        """Report how each node executes in the steady-state block path
        (batched kernel vs composed path, fused mix-down, fused epilogue,
        scan island or dissolved island); in sample mode every device node
        reports ``path="tick"``.

        Deviation from the JAX package, which traces the block abstractly
        (``jax.eval_shape``, no device work): the port runs one real block
        on the current state, on the device, and discards the result.  The
        compiled state is untouched (every state update is out of place);
        the kernels' ``launches`` counters and the host-side state the
        staging would advance (queued events, ramps, host-node control
        state) are snapshotted and restored, so a later run is as if
        ``explain`` had not been called.  It costs one block of device
        time."""
        from ..ops import conv
        from ..ops.cuda import launch_counters
        from . import explain as _explain
        B = int(block_len or self.block_size)
        counters = launch_counters() + [conv.launches]
        saved_launches = [dict(c) for c in counters]
        saved_queues = {k: list(q) for k, q in self._event_queues.items()}
        saved_params = copy.deepcopy(self._params)
        saved_hosts = {
            name: ([copy.deepcopy(self.ir.nodes[name].node.__dict__)]
                   if self.ir.nodes[name].count == 1 else
                   [copy.deepcopy(n.__dict__)
                    for n in self.prog.host_instances[name]])
            for name in self.prog.host_nodes}
        saved_steady = copy.deepcopy(self._host_steady)
        saved_ev_outs = self._last_event_outs
        entries: list = []
        try:
            per_block, ev_bufs = self._steady_staging(B)
            with _explain.recording(entries):
                self._block_fn(B)(self._state, per_block, ev_bufs)
        finally:
            for k, evs in saved_queues.items():
                self._event_queues[k][:] = evs
            self._params = saved_params
            for name, saved in saved_hosts.items():
                nodes = ([self.ir.nodes[name].node]
                         if self.ir.nodes[name].count == 1
                         else self.prog.host_instances[name])
                for n, s in zip(nodes, saved):
                    n.__dict__.update(s)
            self._host_steady = saved_steady
            self._last_event_outs = saved_ev_outs
            for c, saved in zip(counters, saved_launches):
                c.update(saved)
        if formatted:
            return _explain.format_report(entries)
        return entries
