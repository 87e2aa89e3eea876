"""oscen_tpu_torch's graph front end against the JAX package's: the
electric piano lowers to the same IR, and diagnostics and unported paths
fail loudly."""

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
