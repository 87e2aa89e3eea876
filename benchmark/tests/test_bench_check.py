"""The check that decides ``correct``, on the CPU at a small size: sound
runs of the program pass their limits; the control (the reference in
bfloat16, in the program's place) fails them; and a run with the timed path
broken underneath comes out not correct, for each fault a cell can have:
a block that leaves the state as it was, half the voices left out of the
mix, an answer altered where it is produced.  (One card: no exchange
between cards to leave out.)"""

import pytest
import torch

from benchmark.cell import load
from benchmark.check import failures, numbers, verdict
from benchmark.run import judge, measure
from benchmark.tests.small import small_root
from oscen_tpu_torch.graph.compile import CompiledGraph

CELLS = ["epiano256.held.b1024", "fm256.held.b1024"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("small"))


def outcome(root, name, seed=17, control=None):
    cell = load(root, name)
    m = measure(cell, seed, 0.3, False, "cpu", 0.0)
    nums = numbers(judge(cell, m, control=control))
    limits = {k: float(v) for k, v in cell.config["limits"].items()}
    return verdict(nums, limits), nums


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_pass_and_the_control_fails(root, name):
    ok, nums = outcome(root, name)
    assert ok, nums
    ok, nums = outcome(root, name, control=torch.bfloat16)
    assert not ok, nums


def stuck(orig):
    """Each block leaves the program's state as it found it."""
    def process_block(self, *a, **k):
        before = self.state
        out = orig(self, *a, **k)
        self.state = before
        return out
    return process_block


def half_voices(orig):
    """Before each block, the odd voices are silenced: half the mix."""
    def silence(state):
        if "voices" in state:                       # the piano
            amp = state["voices"]["amp"]
            amp["current"][1::2] = 0.0
            amp["target"][1::2] = 0.0
        else:                                       # the FM synth
            env = state["voices.envs"]
            env["level"][1::2] = 0.0
            env["stage"][1::2] = 0
            env["rem"][1::2] = 0
        return state

    def process_block(self, *a, **k):
        self.state = silence(self.state)
        return orig(self, *a, **k)
    return process_block


def altered(orig):
    """Each block's output has one sample moved by 1% of its peak."""
    def process_block(self, *a, **k):
        out = orig(self, *a, **k)
        for y in out.values():
            if isinstance(y, torch.Tensor) and y.numel():
                y.view(-1)[y.numel() // 2] += 0.01 * float(y.abs().max())
        return out
    return process_block


@pytest.mark.parametrize("fault", [stuck, half_voices, altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(root, name, fault,
                                            monkeypatch):
    monkeypatch.setattr(CompiledGraph, "process_block",
                        fault(CompiledGraph.process_block))
    ok, nums = outcome(root, name)
    assert not ok, nums


def test_a_quiet_stretch_is_judged_on_its_own_scale():
    """A decayed stretch, a thousandth as loud as the chord's onset, with
    one sample off by 1% of its own peak, fails the limit that the loud
    stretch alone passes."""
    limits = {"out_gap": 2e-3, "state_gap": 0.05, "state_mismatch": 0}
    loud = {"abs": 1e-5, "peak": 10.0, "state_gap": 0.0,
            "state_mismatch": 0}
    quiet = {**loud, "abs": 1e-4, "peak": 1e-2}
    assert verdict(numbers([loud]), limits)
    assert numbers([loud, quiet])["out_gap"] == pytest.approx(1e-2)
    assert not verdict(numbers([loud, quiet]), limits)
    assert failures([loud, quiet], limits) == 1
