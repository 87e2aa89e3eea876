"""``oscen_tpu_torch.bench``, the port's benchmark driver, and
``oscen_tpu_torch.tools.fusedrms`` on the CPU.

- Each of the eight ``--model=`` names, built by the bench's model table
  at 4 voices (where the model has voices) and compiled at B=64, against
  the JAX package's builder of the same model with the same chord: the
  chord's block and ``steady_checksum(3)``.  Each model is held to the
  max-abs bound its slice's tests already pin against JAX (PERF.md,
  section 2; ``tests/torch_jax_distance.py``): the piano 1e-4
  (``test_torch_electric_piano.py``), the poly synth, README synth, fm synth
  and pivot 1e-5 (``test_torch_poly_synth.py``, ``test_torch_fm_synth.py``),
  the twin peaks, echo and saturator 1e-6 (``test_torch_twin_peaks.py``,
  ``test_torch_echo_saturator.py``).  The checksum sums the squares of the
  N samples of 3 blocks, so a sample bound d gives, by Cauchy-Schwarz,
  ``|ck - ck_jax| <= 2 d sqrt(N ck_jax) + N d^2``: a relative tolerance of
  ``2 d sqrt(N / ck_jax) + N d^2 / ck_jax`` (about 2 d / RMS).
- The metric names, written out, against ``bench.py``'s formulas; the
  unknown-model error against ``bench.py``'s text.
- The warm block's time and the span function; on the CPU (``--device
  cpu``) the steady command end to end, stopped by SIGTERM after its first
  line, and the child's ``--events`` loops in process at 4 voices; without
  a card the command fails at once and is not retried; the start-up
  watchdog kills a child that hangs; the child builds every kernel
  source.
- ``tools/fusedrms.py`` at 4 voices, 0.1 s, B=64, within the JAX package's
  fused-path bound.
"""

import json
import math
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import oscen_tpu as J
from oscen_tpu.models.electric_piano import build_electric_piano as jpiano
from oscen_tpu.models.fm_synth import build_fm_synth as jfm
from oscen_tpu.models.pivot import build_pivot as jpivot
from oscen_tpu.models.poly_synth import build_poly_synth as jpoly
from oscen_tpu.models.simple import (build_saturator as jsat,
                                     build_simple_echo as jecho,
                                     build_simple_synth as jsimple)
from oscen_tpu.models.twin_peaks import build_twin_peaks as jtwin
from oscen_tpu_torch import bench
from oscen_tpu_torch.tools import fusedrms

ROOT = Path(__file__).resolve().parents[1]
SR = 48000.0
B = 64
VOICES = 4

# name -> (the JAX package's graph at VOICES voices, the max-abs bound)
JAX_MODELS = {
    "electric_piano": (lambda: jpiano(VOICES), 1e-4),
    "poly_synth": (lambda: jpoly(VOICES), 1e-5),
    "fm_synth": (lambda: jfm(VOICES), 1e-5),
    "pivot": (lambda: jpivot(VOICES), 1e-5),
    "readme_synth": (jsimple, 1e-5),
    "simple_echo": (jecho, 1e-6),
    "saturator": (lambda: jsat(factor=4), 1e-6),
    "twin_peaks": (jtwin, 1e-6),
}


def _streams(outs):
    """A block's stream outputs as numpy, by name."""
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in outs.items() if hasattr(v, "shape")}


@pytest.mark.parametrize("name", sorted(JAX_MODELS))
def test_bench_model_matches_jax(name):
    make_jax, atol = JAX_MODELS[name]
    graph, voices = bench.build_model(name, VOICES)
    assert voices == (VOICES if bench.MODELS[name][1] else 1)
    t = graph.compile(SR, block_size=B, device="cpu")
    bench.strike_chord(t, voices)
    j = make_jax().compile(SR, block_size=B)
    if any(i.name == "midi_in" for i in j.ir.inputs):
        for i in range(voices):
            j.queue_event("midi_in", 0,
                          J.raw_midi_event([0x90, 36 + (i % 64), 100]))
    a, b = _streams(j.process_block()), _streams(t.process_block())
    assert sorted(a) == sorted(b)
    n = 0
    for k in a:
        assert a[k].shape == b[k].shape
        np.testing.assert_allclose(b[k], a[k], atol=atol, rtol=0)
        n += 3 * a[k].size
    if voices > 1:
        assert max(np.abs(v).max() for v in a.values()) > 0.01
    ck_j, ck_t = j.steady_checksum(3), t.steady_checksum(3)
    assert abs(ck_t - ck_j) <= 2 * atol * math.sqrt(n * ck_j) + n * atol ** 2


def test_unknown_model_raises_bench_py_error():
    # bench.py:192-194, written out
    with pytest.raises(SystemExit, match=r"^unknown --model=nope "
                       r"\(electric_piano, poly_synth, fm_synth, pivot, "
                       r"readme_synth, simple_echo, saturator, twin_peaks\)$"):
        bench.build_model("nope")


def test_metric_names_are_bench_py_names():
    # bench.py: f"{model}_{NUM_VOICES}v_rtf_48k" + ("" if BLOCK ==
    # BLOCKS[-1] else f"_b{BLOCK}"); f"{model}_{NUM_VOICES}v_events_rtf_48k
    # _b{BLOCK}"
    m = bench.metric_name
    assert m("electric_piano", 256, 4096, False) \
        == "electric_piano_256v_rtf_48k_b4096"
    assert m("electric_piano", 256, 1024, True) \
        == "electric_piano_256v_rtf_48k"
    assert m("electric_piano", 256, 1024, True, events=True) \
        == "electric_piano_256v_events_rtf_48k_b1024"
    assert m("electric_piano", 256, 1024, True, device="cpu") \
        == "cpu_electric_piano_256v_rtf_48k"


@pytest.mark.parametrize("block_s, want", [(20e-6, (256, 2048)),
                                           (2.0, (1, 8)),
                                           (1e-3, (125, 1000))])
def test_spans(block_s, want):
    """20 us (a TPU block): bench.py's 256 / 2048; 2 s (a sample-mode
    block): the minimum; 1 ms (a port block): one second."""
    assert bench.spans(block_s) == want


@pytest.mark.parametrize("fixed_s, block_s", [(0.0, 1.5e-3), (5e-3, 1.5e-3),
                                              (0.2, 20e-6), (1.0, 2.0)])
def test_block_seconds_cancels_the_fixed_cost(fixed_s, block_s):
    """Spans of 1 and 9 blocks that each pay a fixed cost (the staging
    prepass, the final read) give the block's own time, and so the spans of
    that time, whatever the fixed cost."""
    short, long = (fixed_s + n * block_s for n in bench.SIZING)
    assert bench.block_seconds(short, long) == pytest.approx(block_s)
    assert bench.spans(bench.block_seconds(short, long)) \
        == bench.spans(block_s)
    assert bench.block_seconds(0.5, 0.4) == 0.0   # noise: never negative


def test_spans_fit_a_window():
    """Over block times from 1 us to 10 s the long span lasts at most
    SPAN_S unless it is at its minimum, the short one an eighth of it, and
    a window (5 pairs of spans) at most 5 x 1.125 x SPAN_S or 5 x 9
    blocks."""
    for block_s in np.geomspace(1e-6, 10.0, 200):
        n_small, n_large = bench.spans(block_s)
        assert 1 <= n_small < n_large <= bench.MAX_LARGE
        assert n_small == max(1, n_large // 8)
        assert (n_large * block_s <= bench.SPAN_S
                or n_large == bench.MIN_LARGE)
        window_s = 5 * (n_small + n_large) * block_s
        assert window_s <= max(5 * 1.125 * bench.SPAN_S,
                               5 * 9 * block_s) + 1e-12


def _run(args, budget, **env):
    e = {k: v for k, v in os.environ.items()
         if not k.startswith("OSCEN_BENCH_")}
    e.update(OSCEN_BENCH_BUDGET_S=str(budget), **env)
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-m", "oscen_tpu_torch.bench",
                          *args], cwd=ROOT, env=e, capture_output=True,
                         text=True, timeout=budget + 60)
    lines = [json.loads(s) for s in res.stdout.splitlines()
             if s.startswith("{")]
    return res, lines, time.monotonic() - t0


def _run_to_first_line(args, wait_s=240):
    """The command under a budget it never reaches, stopped by SIGTERM as
    soon as it prints its first JSON line: (exit code, its output with
    its errors, JSON lines)."""
    e = {k: v for k, v in os.environ.items()
         if not k.startswith("OSCEN_BENCH_")}
    e["OSCEN_BENCH_BUDGET_S"] = str(wait_s + 60)
    proc = subprocess.Popen([sys.executable, "-m", "oscen_tpu_torch.bench",
                             *args], cwd=ROOT, env=e, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    got: "queue.Queue[str]" = queue.Queue()
    out: list = []

    def pump():
        for ln in proc.stdout:
            out.append(ln)
            got.put(ln)
        got.put("")

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    t_end = time.monotonic() + wait_s
    try:
        while True:
            ln = got.get(timeout=max(0.1, t_end - time.monotonic()))
            if not ln or ln.startswith("{"):
                break
    except queue.Empty:
        pass
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=60)
    finally:
        proc.kill()
    reader.join(timeout=10)
    stdout = "".join(out)
    return rc, stdout, [json.loads(s) for s in stdout.splitlines()
                        if s.startswith("{")]


def _events_in_process(monkeypatch, capsys):
    """The child's ``--events`` run in this process on the 4-voice piano
    (``--events`` needs ``midi_in``; at 256 voices an event block takes
    ~35 ms on this CPU and far longer on a loaded one): (exit code, its
    output, JSON lines)."""
    monkeypatch.setenv("OSCEN_BENCH_CHILD_DEADLINE_S", "300")
    args = bench.parse_args(["--child", "--device", "cpu", "--block=64",
                             "--model=electric_piano", "--events"])
    rc = bench.measure(args, bench.build_model("electric_piano", VOICES))
    stdout = capsys.readouterr().out
    return rc, stdout, [json.loads(s) for s in stdout.splitlines()
                        if s.startswith("{")]


@pytest.mark.parametrize("how, want", [
    ("steady", "cpu_readme_synth_1v_rtf_48k"),
    ("events", "cpu_electric_piano_4v_events_rtf_48k_b64")],
    ids=["steady", "events"])
def test_cli_on_the_cpu(how, want, monkeypatch, capsys):
    """``--device cpu ... --block=64``: the steady command (supervisor and
    child) on the README synth, stopped by SIGTERM after its first line (a
    steady run refines until its budget ends), and the child's
    ``--events`` loops in process: rc 0, ``cpu_`` metric names with
    ``"device": "cpu"``, the headline line last."""
    events = how == "events"
    rc, stdout, lines = (_events_in_process(monkeypatch, capsys) if events
                         else _run_to_first_line(["--device", "cpu",
                                                  "--block=64",
                                                  "--model=readme_synth"]))
    assert rc == 0, stdout
    assert "[bench] device: cpu" in stdout
    assert lines and all(ln["device"] == "cpu" for ln in lines)
    if events:   # every loop's line, each loop of 200 event blocks
        assert [ln["windows"] for ln in lines] \
            == list(range(1, bench.MAX_WINDOWS + 1))
    assert lines[-1]["metric"] == want
    keys = {"metric", "value", "unit", "vs_baseline", "us_per_block",
            "block", "latency_ms", "windows", "device"}
    keys |= ({"events_per_block"} if events
             else {"median_window", "n_small", "n_large"})
    assert set(lines[-1]) == keys
    ln = lines[-1]
    assert ln["value"] > 0 and ln["block"] == 64 and ln["unit"] == "x_realtime"
    assert ln["vs_baseline"] == pytest.approx(ln["value"] / 100.0, abs=1e-4)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")


def test_without_a_card_fails_at_once(no_card):
    """No ``--device cpu`` and no card: a non-zero exit within seconds, no
    JSON line, one attempt."""
    res, lines, secs = _run(["--model=electric_piano"], 120)
    assert res.returncode == bench.NO_CARD
    assert not lines
    assert "torch sees no CUDA card" in res.stderr
    assert "retrying" not in res.stderr
    assert secs < 60


def test_watchdog_kills_a_hung_child():
    """``OSCEN_BENCH_TEST_HANG=1``: no marker within the 2 s start-up
    window, the child is killed, and no retry fits the 8 s budget: rc 1."""
    res, lines, secs = _run(["--device", "cpu"], 8,
                            OSCEN_BENCH_TEST_HANG="1",
                            OSCEN_BENCH_INIT_TIMEOUT_S="2")
    assert res.returncode == 1
    assert not lines
    assert "no progress marker in 2 s" in res.stderr
    assert secs < 30


def test_fusedrms_within_the_fused_path_bound():
    """v4 against parity, 4 voices, 0.1 s, B=64: RMS within the JAX
    package's fused-path bound (5e-4 at 4 voices); the two differ (the
    closed forms are not the exact op order); no launch on the CPU."""
    r = fusedrms.measure(voices=4, block=64, seconds=0.1, device="cpu")
    assert r["bound_rms"] == 5e-4
    assert 0 < r["rms"] <= r["bound_rms"]
    assert r["signal_rms"] > 0.1
    assert len(r["per_second"]) == 1
    assert r["launches"] == {"parity": 0, "v4": 0}
    assert r["metric"] == "cpu_electric_piano_4v_v4_vs_parity"


def test_child_builds_every_kernel_source():
    """The child builds ``build.SOURCES`` before it measures: every
    ``csrc/*.cu`` but ``scanprobe.cu`` (``tools/scanprobe.py``'s probes,
    built by that tool)."""
    from oscen_tpu_torch.ops.cuda import build
    assert set(build.SOURCES) == {
        p.stem for p in build.CSRC_DIR.glob("*.cu")} - {"scanprobe"}
