"""The FM slice end to end on the CPU: oscen_tpu_torch against the JAX
package, and the port's own invariants.

- The block compiler's constant and literal analysis (``literal_ins``,
  ``host_ins``, ``const_outs``) and what it decides in the models.
- Nodes: the stateless nodes (Gain, Vca, Mixer, Crossfade, AddValue,
  MulAdd, with both literal-0 folds), ``FmOperator`` (one node and an
  array of 3) and ``AdsrBank``, against JAX's ``CompiledGraph``.
- ``build_fm_synth(4)`` and ``build_pivot(4)``, fused and unfused, against
  JAX's composed path (its per-sample tick scans on the CPU), the IR both
  lower to, ``explain()``, state carried from JAX, and the pivot's
  block-size invariance, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import oscen_tpu as J
import oscen_tpu_torch as T
from oscen_tpu.models import fm_synth as jfm_mod
from oscen_tpu.models import pivot as jpv_mod
from oscen_tpu.nodes import basic as jbasic
from oscen_tpu.nodes import envelope as jenv
from oscen_tpu_torch.core.types import stream, value
from oscen_tpu_torch.models import fm_synth as tfm_mod
from oscen_tpu_torch.models import pivot as tpv_mod
from oscen_tpu_torch.nodes import basic as tbasic
from oscen_tpu_torch.nodes import envelope as tenv
from oscen_tpu_torch.ops.cuda import fm as tfm
from oscen_tpu_torch.utils.convert import state_from_jax, state_to_numpy

SR = 48000.0
ATOL = 1e-5
PKGS = {"jax": (J, jbasic, jenv, jfm_mod, jpv_mod),
        "torch": (T, tbasic, tenv, tfm_mod, tpv_mod)}


def _cpu(pkg):
    """The port's graphs compile for the card unless asked for the CPU; the
    JAX package's ``compile`` takes no device."""
    return {"device": "cpu"} if pkg is T else {}


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ #
# block compiler: literal_ins, host_ins, const_outs
# ------------------------------------------------------------------ #
class _LiteralProbe(T.Node):
    """A node array whose batched method takes ``literal_ins`` and
    ``host_ins`` (and no defaults, so a compiler that does not pass them
    fails the call)."""

    INPUTS = (value("level", 1.0), value("offset", 0.25), stream("x", 0.0))
    OUTPUTS = (stream("output"),)
    BATCHED = True

    def __init__(self):
        self.seen = []

    def process_block(self, state, ins, events, sr, block_len):
        return state, {"output": ins["level"] * ins["x"] + ins["offset"]}

    def process_block_batched(self, state, ins, events, sr, block_len, *,
                              literal_ins, host_ins):
        self.seen.append((literal_ins, host_ins))
        return self.process_block(state, ins, events, sr, block_len)


def test_batched_method_receives_literal_and_host_ins():
    """A never-set graph parameter is a literal (its default); an
    unconnected input is a literal (its default); ``2 * param`` folds.
    Setting the parameter drops it from the literals and rebuilds the
    block function once; while it is idle its host value is known, while
    it ramps it is not.  A stream fed from a graph stream is neither."""
    g = T.Graph("P")
    level = g.input("level", "value", default=0.5)
    g.input("x", "stream")
    g.output("out", "stream")
    p = g.add("p", _LiteralProbe(), count=2)
    g.connect(level * 2.0, p.level)
    g.connect("x", p.x)
    g.connect(p.output, "out")
    c = g.compile(SR, block_size=32, device="cpu")
    probe = c.ir.nodes["p"].node
    x = {"x": np.ones(32, np.float32)}
    c.process_block(stream_inputs=x)
    c.process_block(stream_inputs=x)
    c.set_value("level", 0.75)
    c.process_block(stream_inputs=x)
    c.set_value_with_ramp("level", 1.0, 64)
    c.process_block(stream_inputs=x)
    lit0, host0 = probe.seen[0]
    assert lit0 == {"level": 1.0, "offset": 0.25}      # 2 * 0.5
    assert host0 == lit0
    assert probe.seen[1] == probe.seen[0]
    assert len(c._block_fns) == 2               # rebuilt once, not per block
    lit2, host2 = probe.seen[2]
    assert lit2 == {"offset": 0.25}
    assert host2 == {"offset": 0.25, "level": 1.5}     # 2 * 0.75
    lit3, host3 = probe.seen[3]
    assert lit3 == {"offset": 0.25} and host3 == {"offset": 0.25}


def _cutoff_mod_graph(pkg, basic, env):
    """gate -> ADSR array -> MulAdd(amount, 1500) -> TptFilter.cutoff,
    with a saw-like stream into the filter."""
    g = pkg.Graph("M")
    g.input("gate", "event")
    g.input("amount", "value", default=0.0)
    g.input("x", "stream")
    g.output("out", "stream")
    e = g.add("e", env.AdsrEnvelope(0.002, 0.01, 0.5, 0.01), count=3)
    m = g.add("m", basic.MulAdd(0.0, 1500.0), count=3)
    f = g.add("f", pkg.TptFilter(1500.0, 0.9), count=3)
    g.connect("gate", e.gate)
    g.connect(e.output, m.input)
    g.connect("amount", m.gain)
    g.connect(m.output, f.cutoff)
    g.connect("x", f.input)
    g.connect(f.output, "out")
    return g


def test_literal_zero_gain_makes_the_filter_cutoff_block_constant():
    """A MulAdd with a literal 0.0 gain proves its output block-constant,
    so the filter's cutoff is and it hoists its coefficients; the first
    set_value on the gain drops the specialization and the filter sweeps
    its coefficients per sample.  The audio matches the JAX package
    throughout."""
    B = 64
    x = (0.5 * np.sign(np.sin(np.arange(6 * B) / 7.0))).astype(np.float32)
    outs, cs = {}, {}
    for name, (pkg, basic, env, _, _) in PKGS.items():
        c = _cutoff_mod_graph(pkg, basic, env).compile(SR, block_size=B,
                                                       **_cpu(pkg))
        c.queue_event("gate", 5, 1.0)
        blocks = []
        for i in range(6):
            if i == 3:
                if name == "torch":
                    rep = c.explain()
                    assert {"node": "m", "const_outputs": ["output"]} in rep
                    assert {"node": "f", "kernel": "tpt_svf_scan",
                            "coef_path": "hoisted"} in rep
                c.set_value("amount", 4000.0)
            blocks.append(_np(c.process_block(
                stream_inputs={"x": x[i * B:(i + 1) * B]})["out"]))
        outs[name], cs[name] = np.concatenate(blocks), c
    rep = cs["torch"].explain()
    assert not [e for e in rep if "const_outputs" in e]
    assert {"node": "f", "kernel": "tpt_svf_scan",
            "coef_path": "sweep"} in rep
    assert np.abs(outs["jax"]).max() > 0.1
    np.testing.assert_allclose(outs["torch"], outs["jax"], atol=ATOL, rtol=0)


# ------------------------------------------------------------------ #
# nodes against the JAX package
# ------------------------------------------------------------------ #
def _stateless_graph(pkg, basic, count):
    """Every stateless node once, Gain(0.0) with an unconnected (literal)
    gain among them, fed by two streams and two value parameters."""
    g = pkg.Graph("S")
    g.input("a", "stream")
    g.input("b", "stream")
    g.input("mix", "value", default=0.3)
    g.input("k", "value", default=0.8)
    g.output("out", "stream")
    n = {nm: g.add(nm, mk, count=count) for nm, mk in (
        ("vca", basic.Vca()), ("xf", basic.Crossfade()),
        ("mixer", basic.Mixer()), ("gain", basic.Gain(1.5)),
        ("zero", basic.Gain(0.0)), ("add", basic.AddValue(0.2)),
        ("muladd", basic.MulAdd(0.5, -0.1)),
        ("zmuladd", basic.MulAdd(0.0, 0.4)))}
    g.connect("a", n["vca"].input)
    g.connect("b", n["vca"].control)
    g.connect(n["vca"].output, n["xf"].input)
    g.connect("mix", n["xf"].mix)
    g.connect(n["xf"].output_a, n["mixer"].input_a)
    g.connect(n["xf"].output_b, n["gain"].input)
    g.connect(n["gain"].output, n["mixer"].input_b)
    g.connect(n["mixer"].output, n["add"].input)
    g.connect("k", n["add"].value)
    g.connect(n["add"].output, n["muladd"].input)
    g.connect("b", n["zero"].input)
    g.connect("a", n["zmuladd"].input)
    g.connect(n["muladd"].output + n["zero"].output + n["zmuladd"].output,
              "out")
    return g


@pytest.mark.parametrize("count", [1, 3])
def test_stateless_nodes_match_jax(count):
    """Per-sample streams, a parameter ramp; the literal-0 folds (Gain and
    MulAdd) and the const outputs the nodes declare match the JAX
    package's explain() notes."""
    B, n = 64, 4
    rng = np.random.default_rng(count)
    a = rng.standard_normal(B * n).astype(np.float32)
    b = rng.uniform(0, 1, B * n).astype(np.float32)
    outs, notes = {}, {}
    for name, (pkg, basic, _, _, _) in PKGS.items():
        c = _stateless_graph(pkg, basic, count).compile(SR, block_size=B,
                                                        **_cpu(pkg))
        blocks = []
        for i in range(n):
            if i == 2:
                c.set_value_with_ramp("mix", 0.9, 40)
            blocks.append(_np(c.process_block(stream_inputs={
                "a": a[i * B:(i + 1) * B], "b": b[i * B:(i + 1) * B]})["out"]))
        outs[name] = np.concatenate(blocks)
        notes[name] = {(e["node"], tuple(e["const_outputs"]))
                       for e in c.explain() if "const_outputs" in e}
    assert np.abs(outs["jax"]).max() > 0.5
    np.testing.assert_allclose(outs["torch"], outs["jax"], atol=ATOL, rtol=0)
    assert notes["torch"] == notes["jax"] == {
        ("zero", ("output",)), ("zmuladd", ("output",))}


def _fm_operator_graph(pkg, basic, count):
    g = pkg.Graph("F")
    g.input("freq", "value", default=330.0)
    g.input("fb", "value", default=0.4)
    g.input("pm", "stream")
    g.input("env", "stream")
    g.output("out", "stream")
    op = g.add("op", basic.FmOperator(), count=count)
    g.connect("freq", op.base_freq)
    g.connect("fb", op.feedback)
    g.connect("pm", op.phase_mod)
    g.connect("env", op.envelope)
    g.connect(op.output, "out")
    return g


@pytest.mark.parametrize("count", [1, 3])
def test_fm_operator_matches_jax(count):
    """One operator and an array of 3 (the K14 plain version on the CPU),
    phase modulation and envelope streams, feedback 0.4, a frequency ramp:
    atol 1e-5 against JAX's tick scan."""
    B, n = 64, 5
    rng = np.random.default_rng(10 + count)
    pm = rng.uniform(-0.2, 0.2, B * n).astype(np.float32)
    env = rng.uniform(0.2, 1.0, B * n).astype(np.float32)
    outs = {}
    tfm.reset_launches()
    for name, (pkg, basic, _, _, _) in PKGS.items():
        c = _fm_operator_graph(pkg, basic, count).compile(
            SR, block_size=B, **_cpu(pkg))
        blocks = []
        for i in range(n):
            if i == 2:
                c.set_value_with_ramp("freq", 880.0, 100)
            blocks.append(_np(c.process_block(stream_inputs={
                "pm": pm[i * B:(i + 1) * B],
                "env": env[i * B:(i + 1) * B]})["out"]))
        outs[name] = np.concatenate(blocks)
        if name == "torch" and count > 1:
            assert {"node": "op", "path": "batched"} in c.explain()
    assert np.abs(outs["jax"]).max() > 0.3
    np.testing.assert_allclose(outs["torch"], outs["jax"], atol=ATOL, rtol=0)
    assert tfm.launches["fm_operator_scan"] == 0


def _bank_graph(pkg, env, count):
    g = pkg.Graph("A")
    g.input("gate", "event")
    g.input("rel", "value", default=0.02)
    g.output("out", "stream")
    bank = g.add("bank", env.AdsrBank([
        ("a", 0.004, 0.03, 0.6, 0.05), ("b", 0.0, 0.02, 0.5, 0.0),
        ("c", 0.01, 0.2, 0.8, 0.5), ("d", 0.002, 0.01, 0.3, 0.01)]),
        count=count)
    g.connect("gate", bank.gate)
    g.connect("rel", bank.d_release)
    g.connect(bank.a + 2.0 * bank.b + 3.0 * bank.c + 4.0 * bank.d, "out")
    return g


@pytest.mark.parametrize("count", [1, 2])
def test_adsr_bank_matches_jax(count):
    """Four sections (a zero-attack and zero-release one among them), gate
    on and off inside blocks, a retrigger, at B=512: atol 1e-5; the state
    leaves are [C, 4] (or [4]) with the JAX package's dtypes."""
    events = [[(100, 1.0)], [], [(37, 0.0), (300, 0.8)], [(200, 0.0)], []]
    outs, states = {}, {}
    for name, (pkg, _, env, _, _) in PKGS.items():
        c = _bank_graph(pkg, env, count).compile(SR, block_size=512,
                                                 **_cpu(pkg))
        blocks = []
        for evs in events:
            for off, v in evs:
                c.queue_event("gate", off, v)
            blocks.append(_np(c.process_block()["out"]))
        outs[name] = np.concatenate(blocks)
        st = c.state["bank"]
        states[name] = (jax.tree_util.tree_map(np.asarray, st)
                        if name == "jax" else state_to_numpy(st))
    assert np.abs(outs["jax"]).max() > 1.0
    np.testing.assert_allclose(outs["torch"], outs["jax"], atol=ATOL, rtol=0)
    shape = (count, 4) if count > 1 else (4,)
    for key, leaf in states["jax"].items():
        assert states["torch"][key].shape == leaf.shape == shape
        assert states["torch"][key].dtype == leaf.dtype
    np.testing.assert_array_equal(states["torch"]["stage"],
                                  states["jax"]["stage"])


# ------------------------------------------------------------------ #
# the models
# ------------------------------------------------------------------ #
MODELS = {"fm_synth": (jfm_mod.build_fm_synth, tfm_mod.build_fm_synth),
          "pivot": (jpv_mod.build_pivot, tpv_mod.build_pivot)}


def _model_run(pkg, c, feedback_at=None):
    """B=64, 6 blocks: route 0.4, note-ons at samples 7 (a chord) and 90,
    op3_feedback 0.3 from block ``feedback_at`` on (pivot)."""
    outs = []
    for i in range(6):
        if i == 0:
            c.set_value("route", 0.4)
            for note in (48, 60, 67):
                c.queue_event("midi_in", 7,
                              pkg.raw_midi_event([0x90, note, 100]))
        if i == 1:
            c.queue_event("midi_in", 90 - 64,
                          pkg.raw_midi_event([0x90, 72, 90]))
        if i == feedback_at:
            c.set_value("op3_feedback", 0.3)
        outs.append(_np(c.process_block()["audio_out"]))
    return np.concatenate(outs)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_matches_jax(model, fused):
    """Against JAX's composed path on the CPU: max abs 1e-5 with the
    feedback at its default 0; the pivot then runs its last blocks with
    op3_feedback 0.3, rms 1e-4 there (the bound the JAX package holds
    between its two pivot builds, tests/test_pivot.py:129-148)."""
    jb, tb = MODELS[model]
    fb_at = 3 if model == "pivot" else None
    a = _model_run(J, jb(4, fused=fused).compile(SR, block_size=64), fb_at)
    tfm.reset_launches()
    c = tb(4, fused=fused).compile(SR, block_size=64, device="cpu")
    b = _model_run(T, c, fb_at)
    assert b.shape == a.shape == (6 * 64,)
    assert np.abs(a).max() > 0.1
    cut = 3 * 64 if fb_at else a.shape[0]
    np.testing.assert_allclose(b[:cut], a[:cut], atol=ATOL, rtol=0)
    if fb_at:
        assert np.sqrt(np.mean((b[cut:] - a[cut:]) ** 2)) <= 1e-4
    # on the CPU the wrappers run the plain versions: no launches
    assert all(n == 0 for n in tfm.launches.values())


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_lowers_to_the_same_ir(model, fused):
    jb, tb = MODELS[model]
    ja, tg = jb(4, fused=fused).lower(), tb(4, fused=fused).lower()
    assert list(ja.order) == list(tg.order)
    assert {n: (i.count, type(i.node).__name__) for n, i in ja.nodes.items()} \
        == {n: (i.count, type(i.node).__name__) for n, i in tg.nodes.items()}
    assert [(e.dst_node, e.dst_endpoint, e.fanout.value) for e in ja.edges] \
        == [(e.dst_node, e.dst_endpoint, e.fanout.value) for e in tg.edges]


def test_pivot_block_size_invariance():
    """tests/test_pivot.py:113-126 in the port: 512 against 128, bit for
    bit (steady blocks take the zero-feedback branch, the note-on block
    the sequential chain; the two are bit-equal)."""
    def run(bs):
        c = tpv_mod.build_pivot(4).compile(SR, block_size=bs, device="cpu")
        out, pos = [], 0
        while pos < 2048:
            n = min(bs, 2048 - pos)
            if pos <= 100 < pos + n:
                c.queue_event("midi_in", 100 - pos,
                              T.raw_midi_event([0x90, 60, 100]))
            out.append(_np(c.process_block(n)["audio_out"]))
            pos += n
        return np.concatenate(out)
    a = run(512)
    assert np.abs(a).max() > 0.05
    np.testing.assert_array_equal(a, run(128))


def _chain_note(c, kernel):
    return [e for e in c.explain() if e.get("kernel") == kernel][0]


def test_explain_reports_the_zero_feedback_branch():
    """tests/test_explain.py:25-90 in the port: the fm synth's flattened
    feedback defaults are literal zeros; a nonzero default disengages the
    branch; a live feedback parameter engages it at 0.0, disengages after
    set_value(1e-6) and, known on the host, engages again at 0.0."""
    c = tfm_mod.build_fm_synth(4).compile(SR, block_size=64, device="cpu")
    e = _chain_note(c, "fm_chain3")
    assert (e["fast_path"], e["eligible"], e["engaged"]) == \
        ("zero_feedback", True, True)
    assert {"node": e["node"], "path": "batched"} in c.explain()
    assert "engaged=True" in c.explain(formatted=True)

    def synth(fb_default=None, fb_input=False):
        v = T.Graph("V")
        v.input("gate", "event")
        v.output("out", "stream")
        ch = v.add("chain", tfm_mod.FmOperatorChain())
        if fb_default is not None:
            v.input("fbd", "value", default=fb_default)
            v.connect("fbd", ch.op3_feedback)
        if fb_input:
            v.input("fb", "value", default=0.0)
            v.connect("fb", ch.op3_feedback)
        v.connect(ch.output, "out")
        g = T.Graph("S")
        g.input("gate", "event")
        if fb_input:
            g.input("fb", "value", default=0.0)
        vs = g.add("voices", v, count=4)
        g.connect("gate", vs.gate)
        if fb_input:
            g.connect("fb", vs.fb)
        g.output("out", "stream")
        g.connect(vs.out, "out")
        return g

    c = synth(fb_default=0.5).compile(SR, block_size=64, device="cpu")
    assert _chain_note(c, "fm_chain3")["engaged"] is False
    c = synth(fb_input=True).compile(SR, block_size=64, device="cpu")
    assert _chain_note(c, "fm_chain3")["engaged"] is True
    c.set_value("fb", 1e-6)
    e = _chain_note(c, "fm_chain3")
    assert (e["engaged"], e["predicate"]) == (False, "all_zero")
    c.set_value("fb", 0.0)
    assert _chain_note(c, "fm_chain3")["engaged"] is True
    # the pivot: op3_feedback is a live parameter of the app
    p = tpv_mod.build_pivot(4).compile(SR, block_size=64, device="cpu")
    assert _chain_note(p, "pivot_chain3")["engaged"] is True
    p.set_value("op3_feedback", 0.3)
    assert _chain_note(p, "pivot_chain3")["engaged"] is False
    # a block length that is not a multiple of 8 is not eligible
    e = [x for x in p.explain(block_len=60)
         if x.get("kernel") == "pivot_chain3"][0]
    assert (e["eligible"], e["engaged"]) == (False, False)


def test_state_carried_from_jax():
    """The same chord block in both packages, then the JAX state (numpy)
    into the port's CompiledGraph; four more blocks agree at 1e-5.  The
    chain's phases/prevs [C, 3] and the AdsrBank's [C, 4] leaves keep
    their dtypes both ways."""
    jc = jfm_mod.build_fm_synth(4).compile(SR, block_size=64)
    tc = tfm_mod.build_fm_synth(4).compile(SR, block_size=64, device="cpu")
    for c, pkg in ((jc, J), (tc, T)):
        c.set_value("route", 0.4)
        for note in (48, 55, 62, 69):
            c.queue_event("midi_in", 5, pkg.raw_midi_event([0x90, note, 90]))
        c.process_block()
    np_state = jax.tree_util.tree_map(np.asarray, jc.state)
    tc.state = state_from_jax(np_state, device="cpu")
    ops, envs = tc.state["voices.ops"], tc.state["voices.envs"]
    assert ops["phases"].shape == ops["prevs"].shape == (4, 3)
    assert ops["phases"].dtype == torch.float32
    assert envs["stage"].shape == (4, 4) and envs["stage"].dtype == torch.int32
    assert int(envs["stage"].max()) == 1             # attacking
    a = np.concatenate([_np(jc.process_block()["audio_out"])
                        for _ in range(4)])
    b = np.concatenate([_np(tc.process_block()["audio_out"])
                        for _ in range(4)])
    assert np.abs(a).max() > 0.05
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)
    back = state_to_numpy(tc.state)
    jstate = jax.tree_util.tree_map(np.asarray, jc.state)
    for key in ("stage", "rem", "age", "stage_len"):
        assert back["voices.envs"][key].dtype == np.int32
        np.testing.assert_array_equal(back["voices.envs"][key],
                                      jstate["voices.envs"][key])
    np.testing.assert_array_equal(back["voices.ops"]["phases"],
                                  jstate["voices.ops"]["phases"])
