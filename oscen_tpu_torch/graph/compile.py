"""Graph compiler: IR → block function over torch tensors on one device.

Counterpart of ``oscen_tpu/graph/compile.py`` in block mode.  The
reference emits Rust whose ``process_block`` advances every node one
sample in topological order (codegen/mod.rs:539, emit_frame.rs); here each
node's time-vectorized ``process_block`` runs over whole ``[B]`` blocks
(graph/block_mode.py), eagerly, on the device given to ``compile``.

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
``state["__fb__"]``.  Sample mode (the per-sample schedule) and per-sample
scan islands are not ported yet and raise ``NotImplementedError``.
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
from .ir import (BinOp, Call, Const, EdgeKernel, EndpointRef, Expr,
                 FrameCtor, IrEdge, IrGraph, IrNodeInst)
from .node import StepValue, tree_map

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
                 device: torch.device):
        self.ir = ir
        self.sr = SampleRate(float(sample_rate))
        self.device = device
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
            s = tree_map(lambda x: x.to(self.device),
                         inst.node.init_state(self.scaled_sr(inst)))
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
            # filled on the device: torch.tensor(value, device=cuda) is a
            # synchronizing host-to-device copy on every block
            return torch.full((), expr.value, dtype=torch.float32,
                              device=self.device)
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

    @staticmethod
    def segment_sum(v, factor: int) -> Any:
        """Per-outer-instance fan-in for arrays flattened out of array
        subgraphs: (g*m, ...) -> (g, ...) summing each m-segment."""
        return v.reshape((v.shape[0] // factor, factor)
                         + tuple(v.shape[1:])).sum(dim=1)


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
    the CUDA card unless the caller passes ``device="cpu"``.
    """

    def __init__(self, ir: IrGraph, sample_rate: float = 44100.0,
                 block_size: int = DEFAULT_MAX_BLOCK_SIZE,
                 mode: str = "block", device="cuda"):
        if mode == "sample":
            raise NotImplementedError(
                "sample mode (the per-sample schedule) is not ported yet "
                "(ROADMAP.md queue 1, Slice F); use mode='block'")
        if mode != "block":
            raise ValueError(f"unknown mode {mode!r}")
        self.device = resolve_device(device)
        self.ir = ir
        self.mode = mode
        self.block_size = int(block_size)
        self.sample_rate = float(sample_rate)
        self.prog = _Program(ir, sample_rate, self.device)

        # host parameter state
        self._params: Dict[str, ValueRampState] = {}
        self._event_queues: Dict[str, List[EventInstance]] = {}
        for gi in ir.inputs:
            if gi.kind == Kind.VALUE:
                self._params[gi.name] = ValueRampState(float(gi.default))
            elif gi.kind == Kind.EVENT:
                self._event_queues[gi.name] = []

        self.state = self.prog.init_device_state()
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
        # a graph the port cannot run yet (a per-sample scan island) fails
        # at compile time
        self._block_fn(self.block_size)

    # ------------------------------------------------------------------ #
    def init(self, sample_rate: Optional[float] = None) -> None:
        """Re-prepare: rebuild all node state at the given rate."""
        if sample_rate is not None and sample_rate != self.sample_rate:
            self.sample_rate = float(sample_rate)
            self.prog = _Program(self.ir, self.sample_rate, self.device)
            self._block_fns.clear()
        self.state = self.prog.init_device_state()
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
        lits = self._literal_params()
        key = (B, self._literals[1])
        fn = self._block_fns.get(key)
        if fn is None:
            from .block_mode import make_block_fn
            fn = make_block_fn(self.prog, B, literal_params=lits,
                               host_params=self._host_params)
            self._block_fns[key] = fn
        return fn

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
                                  dev[("val", k)], dev[("ok", k)] > 0.5)
                   for k in ev_np}
        return per_block, ev_bufs

    def process_block(self, block_len: Optional[int] = None,
                      stream_inputs: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
        """Advance one block; returns {output name: [B(,C)] tensor on the
        device, event output name: event list}."""
        B = int(block_len or self.block_size)
        steady = stream_inputs is None and self._control_steady()
        if steady and B in self._staging_cache:
            per_block, ev_bufs = self._staging_cache[B]
            self.state, outs = self._block_fn(B)(self.state, per_block,
                                                 ev_bufs)
            return dict(outs)
        self._control_dirty = False  # staging below consumes everything
        ev_np, host_vals = self._host_prepass(B)
        per_block, ev_bufs = self._stage(B, ev_np, host_vals, stream_inputs)
        # a clean-entry block's staging reproduces verbatim until the
        # next control change: keep it on the device
        self._staging_cache = {B: (per_block, ev_bufs)} if steady else {}
        self.state, outs = self._block_fn(B)(self.state, per_block, ev_bufs)
        outs = dict(outs)
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
        fn = self._block_fn(B)
        chunks = []
        for _ in range(int(num_blocks)):
            self.state, outs = fn(self.state, per_block, ev_bufs)
            chunks.append(outs)
        return {k: torch.cat([c[k] for c in chunks], dim=0)
                for k in (chunks[0] if chunks else {})}

    def steady_checksum(self, num_blocks: int,
                        block_len: Optional[int] = None) -> float:
        """Render ``num_blocks`` steady-state blocks and return only the
        energy checksum (sum of squares of every stream output sample),
        accumulated on the device and read once at the end."""
        B = int(block_len or self.block_size)
        per_block, ev_bufs = self._steady_staging(B)
        fn = self._block_fn(B)
        stream_outs = [o.name for o in self.ir.outputs
                       if o.kind != Kind.EVENT]
        acc = torch.zeros((), dtype=torch.float32, device=self.device)
        for _ in range(int(num_blocks)):
            self.state, outs = fn(self.state, per_block, ev_bufs)
            acc = acc + sum(torch.sum(outs[nm] ** 2) for nm in stream_outs)
        return float(acc.item())

    def node_state(self, name: str):
        """A node's current state (nested dict of tensors)."""
        return self.state[name]

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
        (batched kernel vs composed path, fused mix-down, fused epilogue).

        Deviation from the JAX package, which traces the block abstractly
        (``jax.eval_shape``, no device work): the port runs one real block
        on the current state, on the device, and discards the result.  The
        compiled state is untouched (every state update is out of place);
        the kernels' ``launches`` counters and the host-side state the
        staging would advance (queued events, ramps, host-node control
        state) are snapshotted and restored, so a later run is as if
        ``explain`` had not been called.  It costs one block of device
        time."""
        from ..ops.cuda import launch_counters
        from . import explain as _explain
        B = int(block_len or self.block_size)
        counters = launch_counters()
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
                self._block_fn(B)(self.state, per_block, ev_bufs)
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
