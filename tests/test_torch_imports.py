"""oscen_tpu_torch never imports jax: with ``sys.modules["jax"] = None``
(any ``import jax`` then raises) the package imports, and the electric
piano, the poly synth, the README synth, the fm synth, the pivot, the twin
peaks (fused and two-node), an IIR-lowpass graph, the echo, the
saturators (sinc and IIR-halfband boundaries), a graph parsed from the DSL
and the piano with the epilogue fusion and the v3 / v2 kernels build,
compile and render on the CPU."""

import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_and_renders_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import oscen_tpu_torch
        from oscen_tpu_torch import raw_midi_event
        from oscen_tpu_torch.models.electric_piano import (
            build_electric_piano)
        from oscen_tpu_torch.utils import convert  # noqa: F401
        p = build_electric_piano(4).compile(48000.0, block_size=64,
                                            device="cpu")
        p.queue_event("midi_in", 0, raw_midi_event([0x90, 60, 100]))
        a = p.process_block()["out"]
        b = p.process_block()["out"]
        assert a.shape == b.shape == (64, 2)
        assert float(b.abs().max()) > 0.01
        from oscen_tpu_torch.models.poly_synth import build_poly_synth
        from oscen_tpu_torch.models.simple import build_simple_synth
        s = build_poly_synth(4).compile(48000.0, block_size=64, device="cpu")
        s.queue_event("midi_in", 0, raw_midi_event([0x90, 60, 100]))
        assert float(s.process_block()["audio_out"].abs().max()) > 0.001
        r = build_simple_synth().compile(48000.0, block_size=64, device="cpu")
        assert abs(r.render_mono(256)).max() > 0.1
        from oscen_tpu_torch.models.fm_synth import build_fm_synth
        from oscen_tpu_torch.models.pivot import build_pivot
        from oscen_tpu_torch.ops import fastmath  # noqa: F401
        from oscen_tpu_torch.ops.cuda import fm  # noqa: F401
        for build in (build_fm_synth, build_pivot):
            for fused in (True, False):
                m = build(2, fused=fused).compile(48000.0, block_size=64,
                                                  device="cpu")
                m.queue_event("midi_in", 0, raw_midi_event([0x90, 60, 100]))
                m.process_block()
                assert float(m.process_block()["audio_out"].abs().max()) \
                    > 0.01
        import numpy as np
        from oscen_tpu_torch import IirLowpass, Oscillator
        from oscen_tpu_torch.models.twin_peaks import build_twin_peaks
        x = np.random.default_rng(0).standard_normal(512).astype("float32")
        for fused in (True, False):
            t = build_twin_peaks(fused=fused).compile(48000.0, block_size=64,
                                                      device="cpu")
            y = t.render_mono(512, stream_inputs={"audio_in": x})
            assert y.shape == (512,) and 0.01 < abs(y).max() < 10.0
        g = oscen_tpu_torch.Graph("I")
        g.output("out", "stream")
        o = g.add("o", Oscillator.saw(330.0, 0.5))
        f = g.add("f", IirLowpass(1000.0))
        g.connect(o.output, f.input)
        g.connect(f.output, "out")
        i = g.compile(48000.0, block_size=33, device="cpu")
        assert abs(i.render_mono(256)).max() > 0.1
        from oscen_tpu_torch import Delay, HardClip, PolyBlepOscillator
        from oscen_tpu_torch.models.simple import (build_saturator,
                                                   build_simple_echo)
        from oscen_tpu_torch.ops import resample, ringbuffer  # noqa: F401
        from oscen_tpu_torch.nodes import delay  # noqa: F401
        e = build_simple_echo(0.02).compile(48000.0, block_size=256,
                                            device="cpu")
        y = e.render_mono(512, stream_inputs={"x": x})
        assert abs(y).max() > 0.1 and e.explain()[0]["node"] == "delay"
        for policy in ("sinc", "sinc_iir"):
            g = oscen_tpu_torch.Graph("S")
            g.output("out", "stream")
            o = g.add("o", PolyBlepOscillator.saw(2000.0, 0.6), rate=4)
            k = g.add("k", HardClip(), rate=4)
            g.connect(o.output, k.input)
            g.connect(k.output, "out", policy=policy)
            s4 = g.compile(48000.0, block_size=64, device="cpu")
            assert abs(s4.render_mono(256)).max() > 0.5
        assert build_saturator(2).compile(48000.0, block_size=64,
                                          device="cpu").latency_samples() == 5
        assert Delay(10.0).min_delay == 0
        import os
        from oscen_tpu_torch import (AudioInput, EventPassthrough,  # noqa
                                     EventQueue, Value, parse_graph,
                                     parse_oversample_variants)
        from oscen_tpu_torch.graph import dsl  # noqa: F401
        d = parse_graph("output o: stream; nodes { s = Oscillator::sine("
                        "100.0, 1.0); v = Value::new(1.0); } connections "
                        "{ s.output -> o; }")
        assert abs(d.compile(48000.0, block_size=64, device="cpu")
                   .render_mono(128)).max() > 0.5
        v = parse_oversample_variants("base_name: S; factors: [2]; body: "
                                      "{ output o: stream; }")
        assert list(v) == ["S_2x"]
        os.environ["OSCEN_EPILOGUE_FUSION"] = "1"
        os.environ["OSCEN_ADDITIVE_KERNEL"] = "v3"
        p = build_electric_piano(4).compile(48000.0, block_size=64,
                                            device="cpu")
        p.queue_event("midi_in", 0, raw_midi_event([0x90, 60, 100]))
        p.process_block()
        assert {"node": "tremolo", "path": "fused_into_producer_epilogue"} \
            in p.explain()
        os.environ["OSCEN_ADDITIVE_KERNEL"] = "v2"
        assert float(p.process_block()["out"].abs().max()) > 0.01
        assert sys.modules["jax"] is None
        assert not any(m.startswith("oscen_tpu.") or m == "oscen_tpu"
                       for m in sys.modules)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
