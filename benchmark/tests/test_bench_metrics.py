"""The arithmetic of the metrics: the end-to-end metrics see a stall in
the window, the frozen roofline work never reads above 100% for the kernel
times the port has recorded, and the readers count what they say."""

import time
from pathlib import Path

import pytest
import torch

from benchmark import readers, roofline, run as bench
from benchmark.cell import load_reader
from benchmark.check import Plan
from benchmark.loop import Loop
from benchmark.trace import Trace

METRICS = Path(__file__).resolve().parents[1] / "metrics"
B, SR = 1024, 48000.0


class StubGraph:
    """A program that takes ``delay(i)`` seconds for block ``i``."""

    device = torch.device("cpu")

    def __init__(self, delay):
        self.delay, self.i = delay, 0

    def queue_event(self, *a):
        pass

    def process_block(self):
        time.sleep(self.delay(self.i))
        self.i += 1
        return {"out": torch.zeros(B, 2)}

    @property
    def state(self):
        return {}

    block_counts = {"replayed": 0, "eager": 0, "captures": 0}


class NoTraffic:
    def block(self, i):
        return []


def window(delay, seconds=0.6):
    loop = Loop(StubGraph(delay), ["out"], "midi_in", NoTraffic(), 1,
                lambda b: b)
    plan = Plan(0, seconds)
    plan.due = []                       # no check stretches
    m = bench.window(loop, plan, seconds)
    m["setup_s"] = 1.0
    return bench.end_to_end(m, B, SR)


def test_a_stall_in_the_window_moves_rtf_and_the_tail():
    steady = window(lambda i: 0.002)
    # one block in ten stalls for 20 ms: more than 5% of the blocks
    stalled = window(lambda i: 0.022 if i % 10 == 3 else 0.002)
    assert stalled["rtf"] < 0.6 * steady["rtf"]
    assert stalled["block_ms_p95"] > 3 * steady["block_ms_p95"]
    # a single long stall moves the rate, which counts all the time
    one = window(lambda i: 0.25 if i == 5 else 0.002)
    assert one["rtf"] < 0.8 * steady["rtf"]


def test_depth_one_holds_about_two_callbacks_in_the_latency():
    m = window(lambda i: 0.004)
    assert 6.0 < m["block_ms_p95"] < 30.0


def trace_of(kernels, blocks=1, window_ns=None):
    """A trace of back-to-back ``(name, microseconds)`` activities."""
    dev, t = [], 0
    for name, us in kernels:
        dev.append((name, t, int(us * 1e3)))
        t += int(us * 1e3)
    return Trace(blocks=blocks, t0=0, t1=window_ns or t, device=dev)


class FakeRun:
    def __init__(self, trace, voices=256, block=B):
        self.trace, self.voices, self.block_size = trace, voices, block


# the shortest device time a launch of each kernel has read on the card
# (PERF.md: K1 at V=256, B=1024, and K12, K7), with its roofline metric
RECORDED = [("additive_voice_roofline",
             "void (anonymous namespace)::additive_closed_kernel<32, 4, "
             "true>(Planes, int)", 16.9),
            ("additive_voice_roofline",
             "void (anonymous namespace)::additive_parity_kernel<32>(Planes, "
             "int)", 20.9),
            ("fract_phase3_roofline",
             "(anonymous namespace)::fract_phase3_kernel(float const*, "
             "float*)", 9.34),
            ("tpt_svf_scan_roofline",
             "tpt_svf_kernel(float const*, float const*)", 23.6)]


@pytest.mark.parametrize("metric,name,us", RECORDED)
def test_roofline_of_recorded_kernel_times_is_at_most_100(metric, name, us):
    roof = load_reader(METRICS / f"{metric}.py")
    v = roof.read(FakeRun(trace_of([(name, us)])))
    assert 0 < v <= 100.0
    # and of a launch at the least time itself, exactly 100
    least = roofline.least_seconds(*roof.work(256, B)) * 1e6
    assert roof.read(FakeRun(trace_of([(name, least)]))) == pytest.approx(
        100.0, rel=2e-3)          # the trace holds whole nanoseconds


@pytest.mark.parametrize("metric", sorted({r[0] for r in RECORDED}))
def test_roofline_is_silent_without_its_kernels(metric):
    roof = load_reader(METRICS / f"{metric}.py")
    others = [(n, us) for m, n, us in RECORDED if m != metric]
    t = trace_of([("void at::native::vectorized_elementwise_kernel<4>()",
                   5.0)] + others)
    assert roof.read(FakeRun(t)) is None
    assert roof.read(FakeRun(None)) is None


def test_glue_is_pytorchs_kernels_and_copies():
    t = trace_of([("void at::native::vectorized_elementwise_kernel<4>()", 3),
                  ("Memcpy DtoD (Device -> Device)", 2),
                  ("Memset (Device)", 1),
                  ("void additive_closed_kernel<32, 4, true>(Planes)", 18),
                  ("void at_cuda_detail::cub::DeviceScanKernel<>()", 4),
                  ("memcpy32_post", 2),
                  ("(anonymous namespace)::fract_phase3_kernel(float*)", 9)],
                 blocks=2)
    assert readers.glue_us(FakeRun(t)) == pytest.approx(6.0)


def test_busy_is_the_union_of_activities_and_the_gaps_between():
    # two overlapping activities and a gap: busy 40 of 100 ns
    t = Trace(blocks=1, t0=0, t1=100,
              device=[("a", 10, 20), ("b", 20, 20), ("c", 60, 10)])
    assert t.busy_s == pytest.approx(40e-9)
    gaps = t.idle_gaps(3)
    assert [g[1] for g in gaps] == pytest.approx([30e-9, 20e-9, 10e-9])
    # an activity past the window counts only inside it
    t = Trace(blocks=1, t0=0, t1=100, device=[("a", 0, 150)])
    assert t.busy_s == pytest.approx(t.window_s)


def test_submit_is_the_mean_host_time_a_callback():
    class R:
        blocks, submit_s = 4, 0.002
    assert readers.submit_us(R) == pytest.approx(500.0)
