"""Steady-block walls of two trees in turns, on the card: whether a change
moved the host side of ``process_block`` or the host moved.

    python oscen_tpu_torch/tools/wallab.py --old DIR [--rounds 1]

``DIR`` is another tree of the repository (e.g. the parent commit unpacked
by ``git archive``).  Each turn is one process that imports
``oscen_tpu_torch`` from its tree (building that tree's kernels at first
use) and times, at B=1024 on the card: the electric piano (256 voices,
all struck), the poly synth (256 voices), the 4x sinc saturator and the fm
synth (256 voices).  The turns go old, new, new, old per round, so a host
that slows down over the call weighs on both trees alike.  Each model's
wall per steady block is the median over 5 windows of 20 blocks (CUDA
events around the window, the host enqueueing every block); the summary
gives each tree's median and range over its turns and the medians'
ratio.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SR = 48000.0
B = 1024
VOICES = 256
WINDOWS = 5
BLOCKS = 20
MODELS = ("piano", "poly synth", "saturator 4x sinc", "fm synth")
NEW_TREE = Path(__file__).resolve().parents[2]


def _turn(tree: Path) -> dict:
    """One process's walls (µs per steady block) of every model, with the
    package imported from ``tree``."""
    sys.path.insert(0, str(tree))
    import torch

    from oscen_tpu_torch import raw_midi_event
    from oscen_tpu_torch.models.electric_piano import build_electric_piano
    from oscen_tpu_torch.models.fm_synth import build_fm_synth
    from oscen_tpu_torch.models.poly_synth import build_poly_synth
    from oscen_tpu_torch.models.simple import build_saturator
    import oscen_tpu_torch
    assert Path(oscen_tpu_torch.__file__).resolve().is_relative_to(
        tree.resolve()), "the package did not come from the tree"

    def chord(p):
        for i in range(VOICES):
            p.queue_event("midi_in", 0,
                          raw_midi_event([0x90, 36 + (i % 64), 100]))
        return p

    builds = {
        "piano": lambda: chord(build_electric_piano(VOICES).compile(
            SR, block_size=B, mode="block", device="cuda")),
        "poly synth": lambda: chord(build_poly_synth(VOICES).compile(
            SR, block_size=B, device="cuda")),
        "saturator 4x sinc": lambda: build_saturator(4).compile(
            SR, block_size=B, device="cuda"),
        "fm synth": lambda: chord(build_fm_synth(VOICES).compile(
            SR, block_size=B, device="cuda")),
    }
    walls = {}
    for name in MODELS:
        p = builds[name]()
        for _ in range(3):   # the chord's block, then steady ones
            p.process_block()
        torch.cuda.synchronize()
        runs = []
        for _ in range(WINDOWS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(BLOCKS):
                p.process_block()
            b.record()
            torch.cuda.synchronize()
            runs.append(a.elapsed_time(b) * 1e3 / BLOCKS)
        walls[name] = statistics.median(runs)
    return walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, help="the other tree")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn is not None:   # a child: one tree's walls as JSON
        print(json.dumps(_turn(args.turn)), flush=True)
        return 0
    if args.old is None:
        ap.error("--old DIR is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[wallab] {card}; B={B}, {WINDOWS} windows of {BLOCKS} steady "
          f"blocks per model and turn", flush=True)
    got = {"old": [], "new": []}
    for r in range(args.rounds):
        for tag in ("old", "new", "new", "old"):
            tree = args.old if tag == "old" else NEW_TREE
            out = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--turn",
                 str(tree.resolve())], capture_output=True, text=True,
                cwd=str(tree))
            if out.returncode != 0:
                print(out.stderr[-4000:], file=sys.stderr)
                return 1
            walls = json.loads(out.stdout.strip().splitlines()[-1])
            got[tag].append(walls)
            print(f"[wallab] round {r + 1} {tag}: " + ", ".join(
                f"{k} {v:.1f}" for k, v in walls.items()) + " us/block",
                flush=True)
    for name in MODELS:
        old = [w[name] for w in got["old"]]
        new = [w[name] for w in got["new"]]
        mo, mn = statistics.median(old), statistics.median(new)
        print(f"[wallab] {name}: old {mo:.1f} ({min(old):.1f}-"
              f"{max(old):.1f}), new {mn:.1f} ({min(new):.1f}-"
              f"{max(new):.1f}) us/block over {len(old)} turns each "
              f"(new / old {mn / mo:.3f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
