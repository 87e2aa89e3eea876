"""How far the port's filter and echo/saturator slices sit from the JAX
package on the CPU.

Not a test (pytest does not collect it): a measurement that prints the
distances the tests' tolerances rest on.  Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_jax_distance.py

It prints, each on one line:

- XLA's CPU float32 ``tanh`` against the correctly rounded value (the
  port's ``fmath.tanh``) over 1e5 arguments in [-3, 3];
- the twin peaks (fused and two-node) against the JAX compiled graph, its
  CPU scan and its Pallas kernel in interpret mode, over the sequence of
  ``tests/test_torch_twin_peaks.py``;
- the saw -> IirLowpass graph against the JAX graph at B=512, 48 and 33
  with a cutoff change mid-run, and the JAX IIR block against the exact
  float32 recurrence (which the port's plain scan equals bit for bit);
- the port's plain biquad against the Pallas kernel over the chained
  random blocks of ``tests/test_torch_filters.py``;
- the simple echo against the JAX dissolved and scan-island graphs, the
  saturators (sinc at 1x-8x, IIR halfband at 2x and 4x) against the JAX
  compiled graphs, over the sequences of
  ``tests/test_torch_echo_saturator.py``;
- the JAX package's allpass branch (``_allpass_block``, a compiled
  ``lax.scan``) against the exact float32 recurrence (the port's plain
  version) and against the same recurrence with each stage's product and
  sum fused into one rounding (an FMA, emulated in float64).
"""

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("OSCEN_UNROLL_CAP", "1")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_echo_saturator as tes  # noqa: E402
import test_torch_filters as tf  # noqa: E402
import test_torch_twin_peaks as ttp  # noqa: E402
from oscen_tpu.core.types import SampleRate  # noqa: E402
from oscen_tpu.models.twin_peaks import build_twin_peaks  # noqa: E402
from oscen_tpu.nodes.filters import IirLowpass  # noqa: E402
from oscen_tpu.ops import resample as jrs  # noqa: E402
from oscen_tpu.ops.pallas.iir import biquad_scan  # noqa: E402
import oscen_tpu as J  # noqa: E402
import oscen_tpu_torch as T  # noqa: E402
from oscen_tpu_torch.ops.cuda import iir as tiir  # noqa: E402

SR = 48000.0


def ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def main():
    v = np.random.default_rng(0).uniform(-3, 3, 100000).astype(np.float32)
    d = ulps(np.asarray(jax.jit(jnp.tanh)(v)),
             torch.tanh(torch.tensor(v).double()).float().numpy())
    print(f"XLA CPU float32 tanh vs correctly rounded: max {d.max()} ulp, "
          f"{100 * (d > 0).mean():.1f}% of arguments differ")

    for fused in (True, False):
        b = ttp._run(ttp._port(fused))
        for interpret in (False, True):
            if interpret:
                os.environ["OSCEN_PALLAS_INTERPRET"] = "1"
            a = ttp._run(build_twin_peaks(fused=fused).compile(
                SR, block_size=256))
            os.environ.pop("OSCEN_PALLAS_INTERPRET", None)
            print(f"twin peaks {'fused' if fused else 'two-node'} vs JAX "
                  f"{'Pallas interpret' if interpret else 'CPU scan'}: max "
                  f"abs {np.abs(a - b).max():.3e} (peak "
                  f"{np.abs(a).max():.3f}, 2048 samples)")

    for B in (512, 48, 33):
        a, _ = tf._iir_run(J, B, change_at=700)
        b, _ = tf._iir_run(T, B, change_at=700)
        print(f"IIR lowpass graph B={B} vs JAX: max abs "
              f"{np.abs(a - b).max():.3e} (peak {np.abs(a).max():.3f})")

    n = 2048
    x = np.random.default_rng(0).uniform(-0.5, 0.5, n).astype(np.float32)
    node, sr = IirLowpass(1000.0), SampleRate(SR)
    st = node.init_state(sr)
    ins = {"input": jnp.asarray(x), "cutoff": jnp.full((n,), 1000.0),
           "q": jnp.full((n,), np.float32(1 / np.sqrt(2)))}
    _, out = jax.jit(lambda s, i: node.process_block(s, i, {}, sr, n))(
        st, ins)
    coefs = [float(st[k]) for k in ("b0", "b1", "b2", "a1", "a2")]
    y, *_ = tiir.plain_biquad_scan(torch.tensor(x)[:, None],
                                   *[torch.tensor([c]) for c in coefs],
                                   torch.zeros(1), torch.zeros(1))
    print(f"JAX IIR block (1 kHz, {n} samples) vs the exact float32 "
          f"recurrence: max abs "
          f"{np.abs(np.asarray(out['output']) - y[:, 0].numpy()).max():.3e}")

    worst = 0.0
    for V, B in ((1, 48), (3, 37), (130, 64)):
        for per_sample in (False, True):
            rng = np.random.default_rng(V + B + per_sample)
            v_j = [jnp.zeros(V, jnp.float32)] * 2
            v_t = [torch.zeros(V)] * 2
            for _ in range(3):
                xb = (0.5 * rng.standard_normal((B, V))).astype(np.float32)
                c = tf._biquad_coefs(rng, (B, V) if per_sample else (V,))
                yj, *v_j = biquad_scan(jnp.asarray(xb),
                                       *[jnp.asarray(a) for a in c], *v_j,
                                       interpret=True)
                yt, *v_t = tiir.biquad_scan(torch.tensor(xb),
                                            *[torch.tensor(a) for a in c],
                                            *v_t)
                worst = max(worst, float(np.abs(yt.numpy()
                                                - np.asarray(yj)).max()))
    print(f"plain biquad vs Pallas interpret, chained random blocks: max "
          f"abs {worst:.3e}")

    b = tes._echo(T).render_mono(4096, stream_inputs={"x": tes.X})
    for md in (True, False):
        a = tes._echo(J, md).render_mono(4096, stream_inputs={"x": tes.X})
        print(f"simple echo (0.02 s, feedback 0.6, B=512) vs JAX "
              f"{'dissolved' if md else 'scan island'}: max abs "
              f"{np.abs(a - b).max():.3e} (peak {np.abs(a).max():.3f}, "
              f"4096 samples)")
    for policy, factors in (("sinc", (1, 2, 4, 8)), ("sinc_iir", (2, 4))):
        for f in factors:
            a = tes._sat_policy(J, policy, f).compile(SR, 256) \
                .render_mono(2048)
            b = tes._compile(T, tes._sat_policy(T, policy, f), 256) \
                .render_mono(2048)
            print(f"saturator {f}x {policy} vs JAX: max abs "
                  f"{np.abs(a - b).max():.3e} (peak {np.abs(a).max():.3f}, "
                  f"2048 samples)")

    x = np.random.default_rng(1).uniform(-4, 4, 4096).astype(np.float32)
    betas = jrs.BRANCH_A_BETAS
    cur = jnp.asarray(x)
    for beta in betas:
        cur, _, _ = jrs._allpass_block(beta, cur, jnp.float32(0.0),
                                       jnp.float32(0.0))
    jax_y = np.asarray(cur)
    exact, *_ = tiir.plain_allpass_cascade_scan(
        torch.tensor(x)[:, None],
        torch.tensor(np.array(betas, np.float32))[:, None],
        torch.zeros(2, 1), torch.zeros(2, 1))
    fma = x.copy()
    for beta in np.array(betas, np.float32):
        xp = yp = np.float32(0.0)
        for t in range(fma.shape[0]):
            xt = fma[t]
            d = np.float32(xt - yp)
            yp = np.float32(np.float64(beta) * np.float64(d)
                            + np.float64(xp))
            xp, fma[t] = xt, yp
    print(f"JAX allpass branch (lax.scan, 4096 samples, |x| <= 4) vs the "
          f"exact float32 recurrence: max abs "
          f"{np.abs(jax_y - exact[:, 0].numpy()).max():.3e}; vs the FMA "
          f"recurrence: {np.abs(jax_y - fma).max():.3e}")


if __name__ == "__main__":
    main()
