"""oscen_tpu_torch never imports jax: with ``sys.modules["jax"] = None``
(any ``import jax`` then raises) the package imports, and the electric
piano, the poly synth, the README synth, the fm synth, the pivot, the twin
peaks (fused and two-node), an IIR-lowpass graph, the echo, the
saturators (sinc and IIR-halfband boundaries), a graph parsed from the DSL,
the piano with the epilogue fusion and the v3 / v2 kernels, a reverb
(``Convolver``) and a sampler with a scope build, compile and render on
the CPU, and a reverb goes through a checkpoint and a bundle; every module
of ``oscen_tpu_torch.utils`` and ``oscen_tpu_torch.assets`` imports; the
ablation kernels' modules (``ops/cuda/kabl.py``, ``ops/cuda/fractabl.py``)
and every driver of ``oscen_tpu_torch.tools`` import, and a variant of
each runs, without jax, the JAX package or the JAX package's ``tools/``."""

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
        import importlib
        import torch
        from oscen_tpu_torch.ops.cuda import fractabl, kabl
        for t in ("kabl", "kabl2", "kabl3", "kabl4", "kabl5", "kabl6",
                  "fractabl", "fractabl2"):
            importlib.import_module("oscen_tpu_torch.tools." + t)
        x = {k: torch.as_tensor(v) for k, v in importlib.import_module(
            "oscen_tpu_torch.tools.kabl6").inputs(64, H=4, V=8).items()}
        assert kabl.run_variant("kabl6", "v5", x, 64)[0].shape == (64, 1)
        ph = torch.zeros(3, 8)
        assert fractabl.fract_layout("seg", ph, ph + 0.01, 64)[0].shape \
            == (64, 8)
        import tempfile
        from oscen_tpu_torch import (AudioAsset, Convolver, FloatParam,
                                     NihParams, Oscilloscope, SamplePlayer,
                                     TptFilter, nih_params)
        from oscen_tpu_torch.ops import conv, offline_resample  # noqa
        from oscen_tpu_torch.utils import (bundle, checkpoint, host,  # noqa
                                           native, params, profile)
        assert FloatParam and NihParams
        n = np.random.default_rng(9).uniform(-1, 1, 512).astype("float32")
        g = oscen_tpu_torch.Graph("Rv")
        g.input("x", "stream", channels=2)
        g.output("out", "stream", channels=2)
        g.external("ir")
        cv = g.add("cv", Convolver(max_ir_len=128, channels=2))
        g.connect("ir", cv.ir)
        g.connect("x", cv.input)
        g.connect(cv.output, "out")
        rv = g.compile(48000.0, block_size=64, device="cpu")
        rv.publish_asset("ir", AudioAsset.from_samples(n[:100], 48000))
        xs = np.stack([n, n], -1)
        y = rv.render(256, stream_inputs={"x": xs}, tail=32)["out"]
        assert y.shape == (288, 2) and abs(y).max() > 0.1
        with tempfile.TemporaryDirectory() as d:
            bundle.save_bundle(rv, d + "/b")
            rv2 = bundle.load_bundle(d + "/b", device="cpu")
            checkpoint.save_state(rv2, d + "/c.pkl")
            checkpoint.load_state(rv, d + "/c.pkl")
        g = oscen_tpu_torch.Graph("Sm")
        g.output("out", "stream")
        g.external("buf")
        sp = g.add("sp", SamplePlayer(capacity=512))
        f = g.add("f", TptFilter(2000.0, 0.7))
        sc = g.add("sc", Oscilloscope(capacity=128))
        g.connect("buf", sp.buf)
        g.connect(sp.output, f.input)
        g.connect(f.output, sc.input)
        g.connect(sc.output, "out")
        sm = g.compile(48000.0, block_size=64, device="cpu")
        sm.publish_asset("buf", AudioAsset.from_samples(
            np.stack([n[:300], n[:300]]), 44100, graph_rate=48000.0))
        assert abs(sm.render_mono(256)).max() > 0.01
        assert Oscilloscope.snapshot(sm.node_state("sc")).ndim == 1
        assert nih_params(g).names() == []
        assert sys.modules["jax"] is None
        assert not any(m.startswith("oscen_tpu.") or m == "oscen_tpu"
                       for m in sys.modules)
        assert not any(m == "tools" or m.startswith("tools.")
                       for m in sys.modules)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_every_module_class_host_and_example_run_without_jax(tmp_path):
    """Every module of the package imports with jax blocked, among them
    ``utils/voice_classes.py`` and the seven ``examples``; the class host
    switches and each example renders (0.02 s, on the CPU)."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import oscen_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            oscen_tpu_torch.__path__, "oscen_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert "oscen_tpu_torch.utils.voice_classes" in names
        from oscen_tpu_torch import raw_midi_event
        from oscen_tpu_torch.models.electric_piano import (
            build_electric_piano)
        from oscen_tpu_torch.utils.voice_classes import VoiceClassHost
        vc = VoiceClassHost(build_electric_piano, capacities=(2, 4),
                            block_size=64, tail_seconds=0.001,
                            device="cpu")
        vc.queue_event("midi_in", 0, raw_midi_event([0x90, 60, 100]))
        vc.process_block()
        assert vc.active_cap == 2 and vc.switches == 1
        ex = [n for n in names if n.startswith("oscen_tpu_torch.examples.")]
        assert len(ex) == 7, ex
        tmp = {str(tmp_path)!r}
        for name in ex:
            short = name.rsplit(".", 1)[1]
            out = tmp + "/" + short
            argv = {{"streaming_host_demo": ["0.02", "--out", out + ".wav"],
                    "render_convolution": ["", out + ".wav", "--seconds",
                                           "0.01", "--tail", "0.01"]
                    }}.get(short, [out, "--seconds", "0.02"])
            y = importlib.import_module(name).main(argv + ["--device", "cpu"])
            assert y.size and abs(y).max() > 0.0, name
        assert sys.modules["jax"] is None
        assert not any(m.startswith("oscen_tpu.") or m == "oscen_tpu"
                       for m in sys.modules)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
