"""oscen_tpu_torch's graph front end against the JAX package's: the
electric piano lowers to the same IR, and diagnostics and unported paths
fail loudly; explain() disturbs no later run, and stream inputs given as
tensors stage as numpy ones do."""

import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.models.electric_piano import build_electric_piano as jbuild
from oscen_tpu_torch.graph.ir import BinOp, Call, Const, EndpointRef, FrameCtor
from oscen_tpu_torch.models.electric_piano import build_electric_piano as tbuild


def _expr(e):
    """Package-independent structure of a connection expression."""
    kind = type(e).__name__
    if kind == "EndpointRef":
        return ("ref", e.node, e.endpoint, e.index, e.channel)
    if kind == "Const":
        return ("const", e.value)
    if kind == "BinOp":
        return ("op", e.op, _expr(e.lhs), _expr(e.rhs))
    if kind == "FrameCtor":
        return ("frame", tuple(_expr(c) for c in e.channels))
    return (kind, tuple(_expr(a) for a in e.args))


def _ir_summary(ir):
    return {
        "order": list(ir.order),
        "nodes": {n: (i.count, i.rate, type(i.node).__name__)
                  for n, i in ir.nodes.items()},
        "edges": [(_expr(e.source), e.dst_node, e.dst_endpoint, e.dst_index,
                   e.fanout.value, e.kind.value, e.kernel.value,
                   e.is_feedback, e.src_reads_state) for e in ir.edges],
        "inputs": [(i.name, i.kind.value, i.default, i.channels)
                   for i in ir.inputs],
        "outputs": [(o.name, o.kind.value, o.channels) for o in ir.outputs],
        "output_edges": {k: _expr(v) for k, v in ir.output_edges.items()},
    }


@pytest.mark.parametrize("fused", [True, False])
def test_electric_piano_lowers_to_the_same_ir(fused):
    a = _ir_summary(jbuild(8, fused=fused).lower())
    b = _ir_summary(tbuild(8, fused=fused).lower())
    assert a == b
    # the voice output reaches the tremolo through one fan-in edge
    assert any(e[1] == "tremolo" and e[4] == "fan_in" for e in b["edges"])


def test_typo_endpoint_names_node_and_endpoint():
    msgs = []
    for pkg, build in ((J, jbuild), (T, tbuild)):
        g = build(4)
        with pytest.raises(pkg.GraphError) as ei:
            g.connect("brightness", "voices.brightnes")
        msgs.append(str(ei.value))
        voices = pkg.Graph("G")
        node = voices.add("trem", pkg.Tremolo())
        with pytest.raises(pkg.GraphError, match="trem.*'rat'"):
            node.rat
    assert msgs[0] == msgs[1]
    assert "voices" in msgs[1] and "brightnes" in msgs[1]


def test_cycle_is_a_graph_error():
    g = T.Graph("Cyc")
    g.output("out", "stream", channels=2)
    a = g.add("a", T.Tremolo())
    b = g.add("b", T.Tremolo())
    g.connect(a.output[0], b.input)
    g.connect(b.output[0], a.input)
    g.connect(b.output, "out")
    with pytest.raises(T.GraphError, match="cycle"):
        g.lower()


def test_expression_nodes_are_the_ports_own():
    e = (EndpointRef("a", "x") * 0.5 + 1.0)
    assert isinstance(e, BinOp) and isinstance(e.rhs, Const)
    assert isinstance(T.Frame(1.0, 2.0), FrameCtor)
    assert isinstance(T.call(abs, 1.0), Call)


def test_unported_paths_raise():
    g = tbuild(4)
    with pytest.raises(NotImplementedError, match="sample mode"):
        g.compile(48000.0, block_size=64, mode="sample", device="cpu")
    d = T.Graph("Delayed")
    d.output("out", "stream", channels=2)
    t1 = d.add("t1", T.Tremolo())
    t2 = d.add("t2", T.Tremolo())
    d.connect(t1.output[0], t2.input, via=16)
    d.connect(t2.output, "out")
    # the via lowers to a real Delay now, but one with no min_delay
    # promise runs only as the per-sample scan (Slice F)
    assert any(type(i.node).__name__ == "Delay"
               for i in d.lower().nodes.values())
    c = d.compile(48000.0, block_size=64, device="cpu")
    with pytest.raises(NotImplementedError, match="Slice F"):
        c.process_block()


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbuild(4).compile(48000.0, block_size=64, device="cuda")


def test_the_card_is_the_default_device(monkeypatch):
    """Every entry point runs on the card unless the caller asks for the
    CPU: without a card, ``compile()``, ``CompiledGraph`` and
    ``state_from_jax`` that name no device raise (they never carry on on
    the CPU), and ``device="cpu"`` still works."""
    from oscen_tpu_torch.graph.compile import CompiledGraph
    from oscen_tpu_torch.models.twin_peaks import build_twin_peaks
    from oscen_tpu_torch.utils.convert import state_from_jax
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = build_twin_peaks()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        g.compile(48000.0, block_size=64)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        CompiledGraph(g.lower(), 48000.0, 64)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        state_from_jax({"f": {"z": [0.0, 0.0, 0.0]}})
    c = g.compile(48000.0, block_size=64, device="cpu")
    assert c.device.type == "cpu"
    assert c.state["filters"]["z"].device.type == "cpu"
    assert state_from_jax({"z": [1.0]}, device="cpu")["z"].device.type \
        == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        g.compile(48000.0, block_size=64, device="meta")


def _leaves(state):
    from oscen_tpu_torch.graph.node import tree_map
    out = []
    tree_map(out.append, state)
    return out


def test_explain_leaves_counters_and_state(monkeypatch):
    """explain() runs one real block (the JAX package traces abstractly):
    the kernels' launch counters and every state leaf are as they were,
    and the next block equals a run without the call.  The additive
    wrapper's plain version is made to count here, as the kernel does on
    the card."""
    from oscen_tpu_torch.ops.cuda import additive as tadd
    real = tadd.plain_block

    def counting(*a, **kw):
        tadd.launches["v4"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(tadd, "plain_block", counting)

    def started():
        p = tbuild(4).compile(48000.0, block_size=64, device="cpu")
        p.queue_event("midi_in", 0, T.raw_midi_event([0x90, 60, 100]))
        p.process_block()
        p.process_block()
        return p
    p, q = started(), started()
    before = dict(tadd.launches)
    leaves = [x.clone() for x in _leaves(p.state)]
    assert any(e.get("kernel") == "additive_voice_v4" for e in p.explain())
    assert tadd.launches == before
    assert all(torch.equal(a, b) for a, b in zip(leaves, _leaves(p.state)))
    assert torch.equal(p.process_block()["out"], q.process_block()["out"])
    assert tadd.launches["v4"] == before["v4"] + 2


def test_stream_tensors_stage_like_numpy(monkeypatch):
    """A stream input given as a tensor on the graph's device goes in as it
    is, not through the packed host copy (a short tail padded with zeros
    on the device); process_block and render give what the same samples
    give from numpy."""
    from oscen_tpu_torch.graph.compile import CompiledGraph
    from oscen_tpu_torch.models.simple import build_simple_echo
    x = np.random.default_rng(3).standard_normal(700).astype(np.float32)
    copied = []
    real = CompiledGraph._to_device

    def to_device(self, arrays):
        copied.append({k[1] for k in arrays if k[0] == "pb"})
        return real(self, arrays)
    monkeypatch.setattr(CompiledGraph, "_to_device", to_device)

    def echo():
        e = build_simple_echo(0.02).compile(48000.0, block_size=256,
                                           device="cpu")
        e.set_value("feedback", 0.5)
        return e
    a, b = echo(), echo()
    for lo, hi in ((0, 256), (256, 512), (512, 700)):
        ya = a.process_block(stream_inputs={"x": torch.from_numpy(x[lo:hi])})
        assert "x" not in copied[-1]
        yb = b.process_block(stream_inputs={"x": x[lo:hi]})
        assert "x" in copied[-1]
        assert torch.equal(ya["out"], yb["out"])
    ra = echo().render(700, stream_inputs={"x": torch.from_numpy(x)},
                       tail=100)["out"]
    rb = echo().render(700, stream_inputs={"x": x}, tail=100)["out"]
    assert ra.shape == (800,) and np.array_equal(ra, rb)
    assert np.abs(ra).max() > 0.1
