"""oscen_tpu_torch.ops.cuda.additive on the CPU: the plain PyTorch versions
of the fused additive-voice kernels against the JAX package's Pallas
kernels (interpret mode) and against the composed voice.

The inputs are those of the JAX package's own additive tests
(tests/test_electric_piano.py ``_additive_state``): seeded planes with the
step edge cases 0, 64 and 33 in lanes 0-2, chained over 2 blocks.

Bounds: per-voice ``y`` max abs <= 5e-5 and RMS <= 5e-6, state planes
atol 1e-5 — what ``test_additive_parity_kernel_exact_op_order`` pins for
two separately compiled programs of the same op order.  With the fused mix
``y`` is the sum of V such per-voice outputs, so its bounds scale by
sqrt(V) (independent rounding differences add in quadrature).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oscen_tpu.ops.pallas import additive as jadd
from oscen_tpu.ops.pallas.util import pick_unroll as j_pick_unroll
from oscen_tpu_torch.ops.cuda import additive as tadd
from oscen_tpu_torch.ops.cuda.util import pick_unroll

H = 32
KEYS = ("osc_re", "osc_im", "mul_re", "mul_im", "cur", "tgt", "mult")


def _additive_state(V=8, seed=0):
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 0.2, (H, V))
    step = rng.integers(0, 65, (V,)).astype(np.float32)
    step[:3] = (0.0, 64.0, 33.0)
    st = dict(osc_re=rng.normal(size=(H, V)), osc_im=rng.normal(size=(H, V)),
              mul_re=np.cos(th), mul_im=np.sin(th),
              cur=rng.uniform(0, 1, (H, V)), tgt=rng.uniform(0, 1, (H, V)),
              mult=rng.uniform(0.9, 1.0, (H, V)))
    return {k: np.asarray(v, np.float32) for k, v in st.items()}, step


def _chain(call, st, step, blocks=2):
    ore, oim, cur, tgt, s = (st["osc_re"], st["osc_im"], st["cur"],
                             st["tgt"], step)
    ys = []
    for _ in range(blocks):
        y, ore, oim, cur, tgt, s = call(ore, oim, cur, tgt, s)
        ys.append(np.asarray(y))
    return np.concatenate(ys), [np.asarray(x) for x in (ore, oim, cur, tgt,
                                                        s)]


@pytest.mark.parametrize("with_mix", [False, True])
@pytest.mark.parametrize("version,B", [("v4", 64), ("parity", 32),
                                       ("v3", 64), ("v2", 64)])
def test_plain_matches_pallas_interpret(version, B, with_mix):
    V = 8
    st, step = _additive_state(V)

    def jax_call(ore, oim, cur, tgt, s):
        return jadd._additive_voice_block(
            jnp.asarray(ore), jnp.asarray(oim), jnp.asarray(st["mul_re"]),
            jnp.asarray(st["mul_im"]), jnp.asarray(cur), jnp.asarray(tgt),
            jnp.asarray(st["mult"]), jnp.asarray(s), block_len=B,
            interpret=True, with_mix=with_mix, version=version)

    def torch_call(ore, oim, cur, tgt, s):
        t = torch.as_tensor
        return tadd.additive_voice_block(
            t(ore), t(oim), t(st["mul_re"]), t(st["mul_im"]), t(cur),
            t(tgt), t(st["mult"]), t(s), B, with_mix=with_mix,
            version=version)

    y_j, s_j = _chain(jax_call, st, step)
    y_t, s_t = _chain(torch_call, st, step)
    assert y_t.shape == y_j.shape == ((2 * B,) if with_mix else (2 * B, V))
    scale = math.sqrt(V) if with_mix else 1.0
    err = np.abs(y_t - y_j)
    assert err.max() <= 5e-5 * scale, err.max()
    assert np.sqrt(np.mean(err ** 2)) <= 5e-6 * scale
    for a, b in zip(s_t, s_j):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_plain_v4_matches_composed_voice():
    """The fused v4 closed form equals the composed AmplitudeSource ->
    OscillatorBank closed forms of the JAX package for a steady block
    (the bound of test_fused_kernel_interpret_matches_composition)."""
    from oscen_tpu import SampleRate
    from oscen_tpu.nodes.electric_piano import ElectricPianoVoice
    from oscen_tpu.nodes.electric_piano import OscillatorBank as JBank

    sr = SampleRate(48000.0)
    node = ElectricPianoVoice()
    C, B = 3, 128
    st = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(jnp.asarray(x),
                                   (C,) + jnp.shape(jnp.asarray(x))).copy(),
        node.init_state(sr))
    ins1 = {ep.name: jnp.float32(ep.default) for ep in node.INPUTS
            if ep.kind.value == "value"}
    st = jax.vmap(lambda s: node.on_gate(s, jnp.float32(0.9), sr, ins1))(st)
    ins = {k: jnp.broadcast_to(v, (C, B)) for k, v in ins1.items()}
    freq = np.array([220.0, 440.0, 880.0], np.float32)
    ins["frequency"] = jnp.broadcast_to(jnp.asarray(freq)[:, None], (C, B))
    _, out_a = jax.vmap(
        lambda s, i: node.process_block(s, i, {}, sr, B))(st, ins)

    bank, amp = st["bank"], st["amp"]
    mre, mim = jax.vmap(lambda f: JBank._multipliers(f, sr.hz))(
        jnp.asarray(freq))
    mult = jnp.where(amp["released"][:, None], amp["release"], amp["decay"])
    t = torch.as_tensor
    planes = [t(np.asarray(x).T.copy()) for x in (
        jnp.ones_like(bank["osc_re"]), jnp.zeros_like(bank["osc_im"]), mre,
        mim, amp["current"], amp["target"], mult)]
    y, *_ = tadd.additive_voice_block(*planes, t(np.array(amp["step"])),
                                      B, version="v4")
    np.testing.assert_allclose(y.numpy().T, np.asarray(out_a["output"]),
                               atol=1e-4, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    st, step = _additive_state(4)
    planes = [torch.as_tensor(st[k]) for k in KEYS]
    before = dict(tadd.launches)
    for version in tadd.KERNELS:
        y, *_ = tadd.additive_voice_block(*planes, torch.as_tensor(step), 16,
                                          version=version)
        assert y.shape == (16, 4) and y.device.type == "cpu"
    assert tadd.launches == before   # plain versions are not counted


def test_version_and_shape_errors(monkeypatch):
    """v3 and v2 run (by name and through OSCEN_ADDITIVE_KERNEL); an unknown
    version, a ragged block and a device without a kernel raise."""
    st, step = _additive_state(4)
    planes = [torch.as_tensor(st[k]) for k in KEYS]
    s = torch.as_tensor(step)
    for version in ("v2", "v3"):
        y, *_ = tadd.additive_voice_block(*planes, s, 16, version=version)
        assert y.shape == (16, 4)
    monkeypatch.setenv("OSCEN_ADDITIVE_KERNEL", "v2")
    y_env, *_ = tadd.additive_voice_block(*planes, s, 16)
    assert torch.equal(y_env, tadd.plain_v2(*planes, s, 16, 16)[0])
    with pytest.raises(ValueError, match="multiple of 8"):
        tadd.additive_voice_block(*planes, s, 12, version="v4")
    with pytest.raises(ValueError, match="unknown"):
        tadd.additive_voice_block(*planes, s, 16, version="v5")
    monkeypatch.setenv("OSCEN_ADDITIVE_KERNEL", "v5")
    with pytest.raises(ValueError, match="unknown"):
        tadd.additive_voice_block(*planes, s, 16)
    meta = [p.to("meta") for p in planes]
    with pytest.raises(ValueError, match="no additive kernel"):
        tadd.additive_voice_block(*meta, s.to("meta"), 16, version="v4")


def test_plain_v3_equals_plain_v4():
    """The JAX package's invariant (tests/test_electric_piano.py:255-294):
    v3 is bit-identical to v4, over 3 chained blocks through the step edge
    cases 0, 64 and 33, with and without the mix."""
    st, step = _additive_state(8)
    mr, mi, mult = (torch.as_tensor(st[k]) for k in
                    ("mul_re", "mul_im", "mult"))
    for with_mix in (False, True):
        outs = {}
        for version in ("v3", "v4"):
            def call(ore, oim, cur, tgt, s):
                return tadd.plain_block(
                    torch.as_tensor(ore), torch.as_tensor(oim), mr, mi,
                    torch.as_tensor(cur), torch.as_tensor(tgt), mult,
                    torch.as_tensor(s), 256, with_mix, version)
            outs[version] = _chain(call, st, step, blocks=3)
        (y3, s3), (y4, s4) = outs["v3"], outs["v4"]
        assert np.array_equal(y3, y4)
        for a, b in zip(s3, s4):
            assert np.array_equal(a, b)


def test_epilogue_matches_pallas_interpret():
    """The plain epilogue (Tremolo's pan after the mix) against the JAX
    package's kernel with ``epi_fn=Tremolo._epilogue_fn`` in interpret
    mode, V=8, B=64, within the mix bound: a 5 Hz tremolo at tick 100, then
    a 0.02 Hz one whose ticks cross K_REBASE inside the block (the ``a2``
    branch).  The slow rate keeps ``dt*k`` below 1 near K_REBASE: at 5 Hz
    it is ~109 there, where a float32 ulp is 7.6e-6, and XLA contracts
    ``anchor + dt*k`` into an FMA that the port (and its Tremolo node)
    rounds twice, which moves the pan by up to ~8e-6 of the mix."""
    from oscen_tpu.nodes.basic import Tremolo as JTremolo
    V, B = 8, 64
    st, step = _additive_state(V)
    K = float(tadd.K_REBASE)
    params = [np.array([0.3, 100.0, 5.0 / 48000.0, 0.5, 0.7], np.float32),
              np.array([0.3, K - 40.0, 0.02 / 48000.0, 0.5, 0.7],
                       np.float32)]

    def run(call):
        ore, oim, cur, tgt, s = (st["osc_re"], st["osc_im"], st["cur"],
                                 st["tgt"], step)
        ys = []
        for prm in params:
            y, ore, oim, cur, tgt, s = call(ore, oim, cur, tgt, s, prm)
            ys.append(np.asarray(y))
        return np.concatenate(ys), [np.asarray(x) for x in (ore, oim, cur,
                                                            tgt, s)]

    def jax_call(ore, oim, cur, tgt, s, prm):
        return jadd._additive_voice_block(
            jnp.asarray(ore), jnp.asarray(oim), jnp.asarray(st["mul_re"]),
            jnp.asarray(st["mul_im"]), jnp.asarray(cur), jnp.asarray(tgt),
            jnp.asarray(st["mult"]), jnp.asarray(s), block_len=B,
            interpret=True, with_mix=True, epi_fn=JTremolo._epilogue_fn,
            epi_c=2, epi_params=jnp.asarray(prm), version="v4", epi_split=2)

    def torch_call(ore, oim, cur, tgt, s, prm):
        t = torch.as_tensor
        return tadd.additive_voice_block(
            t(ore), t(oim), t(st["mul_re"]), t(st["mul_im"]), t(cur),
            t(tgt), t(st["mult"]), t(s), B, with_mix=True,
            epi_fn=tadd.tremolo_pan, epi_c=2, epi_params=t(prm))

    y_j, s_j = run(jax_call)
    y_t, s_t = run(torch_call)
    assert y_t.shape == y_j.shape == (2 * B, 2)
    err = np.abs(y_t - y_j)
    assert err.max() <= 5e-5 * math.sqrt(V), err.max()
    assert np.sqrt(np.mean(err ** 2)) <= 5e-6 * math.sqrt(V)
    for a, b in zip(s_t, s_j):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    # the second block's ticks crossed the rebase
    assert params[1][1] < K < params[1][1] + B


def test_epilogue_refusals():
    st, step = _additive_state(4)
    planes = [torch.as_tensor(st[k]) for k in KEYS]
    s = torch.as_tensor(step)
    prm = torch.zeros(5)
    with pytest.raises(ValueError, match="with_mix"):
        tadd.additive_voice_block(*planes, s, 16, epi_fn=tadd.tremolo_pan,
                                  epi_c=2, epi_params=prm)
    wide = [torch.zeros(H, 257) for _ in KEYS]
    with pytest.raises(ValueError, match="one voice tile"):
        tadd.additive_voice_block(*wide, torch.zeros(257), 16, with_mix=True,
                                  epi_fn=tadd.tremolo_pan, epi_c=2,
                                  epi_params=prm)
    assert tadd.epilogue_supported(256) and not tadd.epilogue_supported(257)


def test_env_selects_the_parity_version(monkeypatch):
    st, step = _additive_state(4)
    planes = [torch.as_tensor(st[k]) for k in KEYS]
    s = torch.as_tensor(step)
    monkeypatch.setenv("OSCEN_ADDITIVE_KERNEL", "parity")
    y_env, *_ = tadd.additive_voice_block(*planes, s, 32)
    y_par, *_ = tadd.plain_parity(*planes, s, 32)
    assert torch.equal(y_env, y_par)
    assert not tadd.epilogue_supported(4)   # parity opts out


@pytest.mark.parametrize("max_u", [32, 64, 128])
def test_pick_unroll_matches_reference(max_u):
    for n in list(range(1, 300)) + [1024, 4096, 4104]:
        assert pick_unroll(n, max_u) == j_pick_unroll(n, max_u), n
