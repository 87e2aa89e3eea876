"""The readings that the check's limits are set from: for each seed, one
run of a cell with a short window, its numbers compared, and the control's
(the reference computed in bfloat16, put in the program's place from the
same states and MIDI), in one process so that set-up is paid once for the
build:

    python3 -m benchmark.readings --workload <cell> --seconds 2
        --seeds 1,2,3 [--control-seeds 1,2,3]

One JSON line a seed on standard output: ``program`` and ``control``, each
the numbers and the widest gap of each state leaf.  Never run by a check's
runs; the limits in ``configs/<name>.json`` are set from these readings as
PERF.md records.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    import torch
    torch.set_num_threads(1)
    from .cell import load
    from .check import numbers, out_gap
    from .run import judge, measure
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--root", default=None)
    a = ap.parse_args(argv)
    root = Path(a.root) if a.root else Path(__file__).resolve().parents[1]
    cell = load(root, a.workload)
    device = "cpu" if a.rehearse else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    controls = {int(s) for s in a.control_seeds.split(",") if s}
    for seed in [int(s) for s in a.seeds.split(",")]:
        t0 = time.time()
        m = measure(cell, seed, a.seconds, False, device, t0)
        line = {"workload": cell.name, "seed": seed, "blocks": m["blocks"],
                "counts": m["counts"]}
        for side, control in (("program", None), ("control",
                                                   torch.bfloat16)):
            if side == "control" and seed not in controls:
                continue
            t1 = time.perf_counter()
            res = judge(cell, m, control=control)
            leaves = {}
            for r in res:
                for k, v in r["leaves"].items():
                    leaves[k] = max(leaves.get(k, 0.0), v)
            line[side] = {**numbers(res), "leaves": leaves,
                          "out_gap_by_stretch": [out_gap(r) for r in res],
                          "check_s": time.perf_counter() - t1}
        line["run_s"] = time.time() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
