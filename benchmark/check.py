"""Whether what the timed path produced is right: the blocks the window
rendered, held to the plain reference of the configuration
(``reference/<name>.py``), which imports nothing of the program.

The published semantics step every oscillator's phase in float32 (the FM
operators' ``p += dt; p = p.fract()``, the piano's rotation), so over
minutes of audio the program's phases drift by rounding from any reference
computed apart from it: after 10^7 samples by tenths of a cycle.  So the
reference follows the program from the program's own state: at a few
blocks of the window drawn from the seed, ``CompiledGraph.state`` is read
before the block (a copy on the card), and after the window the reference
steps ``SPAN`` blocks from it, with its own allocation of the same MIDI, its
own frequencies, multipliers, spectra and coefficients, and compares the
program's outputs of those blocks and its state after them.  The start,
which this skips, is checked by itself: the first ``START`` blocks of the
run from the reference's own initial state, outputs and the state after
them.

The numbers compared:

- ``out_gap``: over the compared stretches, the widest gap between a block
  the program rendered and the reference's, over the loudest reference
  sample of that stretch (at least ``OUT_FLOOR``), so that a stretch late
  in a decaying chord is judged on its own scale;
- ``state_gap``: over the reference's state leaves after each stretch, the
  widest gap over that leaf's largest value (at least ``STATE_FLOOR``, far
  below hearing); phases as the distance around the cycle;
- ``state_mismatch``: entries of the whole-number state (stages, counts,
  the released flags) that differ.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch

from .traffic import rng_of
from .reference.midi import Voices

SAMPLES = 4        # window blocks drawn from the seed, besides its first
SPAN = 1           # blocks compared from each
START = 3          # blocks compared from the reference's initial state
OUT_FLOOR = 1e-20
STATE_FLOOR = 1e-30


class Plan:
    """Where the window's compared stretches start: its first block and
    ``SAMPLES`` points drawn from the seed, as shares of the window's
    length.  ``segments``: ``{"first": block, "before": state, "after":
    state}``."""

    def __init__(self, seed: int, seconds: float):
        u = np.sort(rng_of(seed, 2).uniform(0.0, 1.0, SAMPLES))
        self.due = [0.0] + [float(x) * seconds for x in u]
        self.segments: List[dict] = []

    @property
    def open(self) -> bool:
        return bool(self.segments) and "after" not in self.segments[-1]

    def before(self, loop, elapsed: float) -> None:
        """Called before each window block: read the state where a stretch
        starts."""
        if self.open or not self.due or elapsed < self.due[0]:
            return
        while self.due and elapsed >= self.due[0]:
            self.due.pop(0)
        self.segments.append({"first": loop.block,
                              "before": loop.c.state})
        loop.keep.update(range(loop.block, loop.block + SPAN))

    def after(self, loop) -> None:
        """Called after each window block: read the state where a stretch
        ends."""
        if self.open and loop.block == self.segments[-1]["first"] + SPAN:
            self.segments[-1]["after"] = loop.c.state


def to_host(tree):
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().cpu()


def reference_of(config: dict):
    return importlib.import_module(
        f"{__package__}.reference.{config['reference']}")


def _leaf_gap(a: torch.Tensor, b: torch.Tensor, phase: bool) -> float:
    d = (a - b).abs()
    if phase:
        d = torch.minimum(d, 1.0 - d)
        return float(d.max())
    return float(d.max() / max(float(b.abs().max()), STATE_FLOOR))


def compare(ref, ys: List[np.ndarray], ys_ref: List[torch.Tensor],
            state: Dict, state_ref: Dict) -> Dict[str, float]:
    """The gaps of one stretch: ``abs`` the widest output gap, ``peak``
    the loudest reference sample."""
    out, peak = 0.0, 0.0
    for y, r in zip(ys, ys_ref):
        r = r.to(torch.float64).reshape(y.shape)
        out = max(out, float((torch.from_numpy(y).to(torch.float64)
                              - r).abs().max()))
        peak = max(peak, float(r.abs().max()))
    leaves, mism = {}, 0
    for k in ref.COMPARED:
        a, b = state[k], state_ref[k]
        if a.dtype in (torch.bool, torch.int64):
            mism += int((a != b.to(a.dtype)).sum())
        else:
            leaves[k] = _leaf_gap(a.to(torch.float64), b.to(torch.float64),
                                  k in ref.PHASES)
    return {"abs": out, "peak": peak, "state_gap": max(leaves.values()),
            "state_mismatch": mism, "leaves": leaves}


def run_reference(config: dict, traffic, start: dict, segments: List[dict],
                  kept: Dict[int, Dict[str, np.ndarray]], output: str,
                  control=None) -> List[dict]:
    """Step the reference over the start and each stretch and compare.
    ``control``: a lower precision (``torch.bfloat16``) in which the
    reference itself stands in for the program, from the same states and
    MIDI; by default the program's kept blocks and states are judged."""
    mod = reference_of(config)
    ref = mod.make(config, torch.float64)
    B = traffic.B
    voices = Voices(int(config["voices"]))
    last = max([START] + [s["first"] + SPAN for s in segments])
    gates, freqs = [], []
    for i in range(last):
        freqs.append(list(voices.frequency))
        gates.append(voices.block(traffic.block(i)))
    stretches = [{"first": 0, "before": None, "after": start}] + segments
    results = []
    for seg in stretches:
        first = seg["first"]
        n = START if seg["before"] is None else SPAN
        f0 = freqs[first]
        s = (ref.init_state(f0) if seg["before"] is None
             else ref.from_program(seg["before"], f0))
        ys_ref = [ref.run_block(s, gates[first + j], B) for j in range(n)]
        if control is None:
            ys = [kept[first + j][output] for j in range(n)]
            state = ref.program_view(seg["after"])
        else:
            other = mod.make(config, control)
            s2 = (other.init_state(f0) if seg["before"] is None
                  else other.from_program(seg["before"], f0))
            ys = [other.run_block(s2, gates[first + j], B).numpy()
                  for j in range(n)]
            state = {k: (v.to(torch.float64) if v.is_floating_point()
                         else v) for k, v in s2.items()}
        results.append(compare(ref, ys, ys_ref, state, s))
    return results


def out_gap(r: dict) -> float:
    """A stretch's widest output gap over its own loudest reference
    sample."""
    return r["abs"] / max(OUT_FLOOR, r["peak"])


def numbers(results: List[dict]) -> Dict[str, float]:
    return {"out_gap": max(out_gap(r) for r in results),
            "state_gap": max(r["state_gap"] for r in results),
            "state_mismatch": float(sum(r["state_mismatch"]
                                        for r in results))}


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(np.isfinite(nums[k]) and nums[k] <= limits[k]
               for k in limits)


def failures(results: List[dict], limits: Dict[str, float]) -> int:
    """The compared stretches that fail a limit."""
    return sum(not verdict({"out_gap": out_gap(r),
                            "state_gap": r["state_gap"],
                            "state_mismatch": float(r["state_mismatch"])},
                           limits) for r in results)
